"""Native runtime components (C++, ctypes-bound).

The reference's IO layer is native C++ (io::webcam over cv::VideoCapture,
src/io/webcam.cpp); this package is the framework's native runtime: a
prefetching frame pump (framepump.cpp) whose producer thread reads a raw
frame stream into a page-aligned SPSC ring while the JAX consumer overlaps
device compute, borrowed zero-copy per frame.

The shared library is compiled on first use with g++ (no pybind11 in this
environment — plain C ABI + ctypes) and cached next to the source; set
CUDACAM_NATIVE_REBUILD=1 to force a rebuild.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from cudacam_tpu.utils.logging import get_logger

log = get_logger("native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "framepump.cpp")
_LIB = os.path.join(_DIR, "libframepump.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
        _SRC, "-o", _LIB,
    ]
    log.info("building native framepump: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (
            not os.path.exists(_LIB)
            or os.environ.get("CUDACAM_NATIVE_REBUILD")
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _build()
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fp_open.restype = ctypes.c_void_p
        lib.fp_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.fp_spec.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.fp_start.restype = ctypes.c_int
        lib.fp_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fp_acquire.restype = u8p
        lib.fp_acquire.argtypes = [ctypes.c_void_p]
        lib.fp_release.argtypes = [ctypes.c_void_p]
        lib.fp_read.restype = ctypes.c_int
        lib.fp_read.argtypes = [ctypes.c_void_p, u8p]
        lib.fp_frames_buffered.restype = ctypes.c_uint64
        lib.fp_frames_buffered.argtypes = [ctypes.c_void_p]
        lib.fp_error.restype = ctypes.c_int
        lib.fp_error.argtypes = [ctypes.c_void_p]
        lib.fp_stop.argtypes = [ctypes.c_void_p]
        lib.fp_close.argtypes = [ctypes.c_void_p]
        lib.fp_write_file.restype = ctypes.c_int
        lib.fp_write_file.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint64,
        ]
        _lib = lib
        return lib


def write_rawv(path: str, frames: np.ndarray) -> str:
    """Write an (N, H, W[, C]) uint8 array as a .rawv stream file."""
    if frames.dtype != np.uint8 or frames.ndim not in (3, 4):
        raise ValueError(f"frames must be uint8 (N,H,W[,C]), got {frames.dtype} {frames.shape}")
    frames = np.ascontiguousarray(frames)
    n, h, w = frames.shape[:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    lib = load_library()
    rc = lib.fp_write_file(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, n,
    )
    if rc != 0:
        raise IOError(f"fp_write_file failed ({rc}) for {path}")
    return path


class FramePump:
    """Zero-copy reader over a .rawv stream with native prefetch.

    ``acquire()`` returns a read-only numpy view of the next ring slot
    (valid until the next acquire); ``read()`` returns an owned copy.
    """

    def __init__(self, path: str, loop: bool = False, ring_slots: int = 4) -> None:
        self._lib = load_library()
        self._h = self._lib.fp_open(path.encode(), 1 if loop else 0)
        if not self._h:
            raise IOError(f"cannot open rawv stream {path}")
        hh = ctypes.c_uint32()
        ww = ctypes.c_uint32()
        cc = ctypes.c_uint32()
        nn = ctypes.c_uint64()
        self._lib.fp_spec(self._h, ctypes.byref(hh), ctypes.byref(ww),
                          ctypes.byref(cc), ctypes.byref(nn))
        self.height, self.width, self.channels = hh.value, ww.value, cc.value
        self.n_frames = nn.value
        self._shape: Tuple[int, ...] = (
            (self.height, self.width, self.channels)
            if self.channels > 1 else (self.height, self.width)
        )
        self._acquired = False
        rc = self._lib.fp_start(self._h, ring_slots)
        if rc != 0:
            self._lib.fp_close(self._h)
            self._h = None
            raise IOError(f"fp_start failed ({rc})")

    @property
    def buffered(self) -> int:
        return int(self._lib.fp_frames_buffered(self._h))

    def acquire(self) -> Optional[np.ndarray]:
        """Borrow the next frame as a zero-copy view; None at end of stream.
        The view is invalidated by the next acquire()."""
        if self._acquired:
            self._lib.fp_release(self._h)
            self._acquired = False
        ptr = self._lib.fp_acquire(self._h)
        if not ptr:
            if self._lib.fp_error(self._h):
                raise IOError("torn frame in rawv stream")
            return None
        self._acquired = True
        n = int(np.prod(self._shape))
        view = np.ctypeslib.as_array(ptr, shape=(n,)).reshape(self._shape)
        view.flags.writeable = False
        return view

    def read(self) -> Optional[np.ndarray]:
        """Owned copy of the next frame; None at end of stream."""
        v = self.acquire()
        if v is None:
            return None
        out = v.copy()
        self._lib.fp_release(self._h)
        self._acquired = False
        return out

    def stop(self) -> None:
        """Phase-1 shutdown, safe from ANY thread: stops the producer and
        wakes a consumer blocked in acquire() (it returns None). Call this
        from a controlling thread, then let the owner call close()."""
        if self._h:
            self._lib.fp_stop(self._h)

    def close(self) -> None:
        """Destroy the pump. Per the C ABI contract (framepump.cpp), no
        other FramePump call on this handle may START once close begins;
        consumers already blocked inside acquire() are drained safely
        (close stops the producer, wakes them, and waits until they leave
        before freeing)."""
        if self._h:
            self._lib.fp_close(self._h)
            self._h = None

    def __enter__(self) -> "FramePump":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

"""Tests for the native C++ frame pump (cudacam_tpu/native/framepump.cpp):
build, rawv round trip, zero-copy acquire, looping, prefetch behavior, and
the RawvSource integration with the app loop."""
from __future__ import annotations

import os
import shutil
import time

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)


@pytest.fixture(scope="module")
def lib():
    from cudacam_tpu.native import load_library

    return load_library()


@pytest.fixture()
def rawv_file(tmp_path, lib):
    from cudacam_tpu.io.sources import make_scene
    from cudacam_tpu.native import write_rawv

    frames = np.stack([make_scene(32, 48, seed=s) for s in range(6)])
    p = str(tmp_path / "clip.rawv")
    write_rawv(p, frames)
    return p, frames


class TestFramePump:
    def test_header_and_roundtrip(self, rawv_file):
        from cudacam_tpu.native import FramePump

        path, frames = rawv_file
        with FramePump(path) as pump:
            assert (pump.height, pump.width, pump.channels) == (32, 48, 3)
            assert pump.n_frames == 6
            got = []
            while True:
                f = pump.read()
                if f is None:
                    break
                got.append(f)
        assert len(got) == 6
        for a, b in zip(got, frames):
            np.testing.assert_array_equal(a, b)

    def test_zero_copy_acquire(self, rawv_file):
        from cudacam_tpu.native import FramePump

        path, frames = rawv_file
        with FramePump(path) as pump:
            v0 = pump.acquire()
            assert v0 is not None and not v0.flags.writeable
            np.testing.assert_array_equal(v0, frames[0])
            v1 = pump.acquire()  # releases slot 0 implicitly
            np.testing.assert_array_equal(v1, frames[1])

    def test_loop_mode(self, rawv_file):
        from cudacam_tpu.native import FramePump

        path, frames = rawv_file
        with FramePump(path, loop=True) as pump:
            got = [pump.read() for _ in range(8)]
        np.testing.assert_array_equal(got[6], frames[0])
        np.testing.assert_array_equal(got[7], frames[1])

    def test_prefetch_fills_ring(self, rawv_file):
        from cudacam_tpu.native import FramePump

        path, _ = rawv_file
        with FramePump(path, ring_slots=3) as pump:
            deadline = time.time() + 2.0
            while pump.buffered < 3 and time.time() < deadline:
                time.sleep(0.01)
            assert pump.buffered == 3  # producer ran ahead without consumer

    def test_mono_stream(self, tmp_path):
        from cudacam_tpu.native import FramePump, write_rawv

        frames = np.random.default_rng(0).integers(
            0, 256, (4, 16, 24), dtype=np.uint8
        )
        p = str(tmp_path / "mono.rawv")
        write_rawv(p, frames)
        with FramePump(p) as pump:
            assert pump.channels == 1
            np.testing.assert_array_equal(pump.read(), frames[0])

    def test_bad_file_rejected(self, tmp_path):
        from cudacam_tpu.native import FramePump

        p = str(tmp_path / "junk.rawv")
        with open(p, "wb") as f:
            f.write(b"not a rawv stream")
        with pytest.raises(IOError):
            FramePump(p)

    def test_write_rejects_bad_input(self, tmp_path):
        from cudacam_tpu.native import write_rawv

        with pytest.raises(ValueError):
            write_rawv(str(tmp_path / "x.rawv"), np.zeros((2, 4, 4), np.float32))


class TestRawvSource:
    def test_source_contract(self, rawv_file):
        from cudacam_tpu.io.sources import RawvSource

        path, frames = rawv_file
        with RawvSource(path) as src:
            assert src.spec == (32, 48, 3)
            got = list(src)
        assert len(got) == 6
        np.testing.assert_array_equal(got[3], frames[3])

    def test_open_source_dispatch(self, rawv_file):
        from cudacam_tpu.io import open_source
        from cudacam_tpu.io.sources import RawvSource

        path, _ = rawv_file
        assert isinstance(open_source(path), RawvSource)
        assert isinstance(open_source(f"rawv:{path}"), RawvSource)

    def test_app_runs_on_rawv(self, rawv_file):
        from cudacam_tpu.app import CannyApp
        from cudacam_tpu.io.sources import RawvSource

        path, _ = rawv_file
        with CannyApp(RawvSource(path)) as app:
            n = app.run(None)  # until EOF
            assert n == 6
            out = app.ring.latest_np()
            assert out.shape == (32, 48) and out.dtype == np.uint8


class TestShutdownContract:
    """fp_stop/fp_close threading contract (framepump.cpp): a consumer
    blocked in acquire() is woken by a cross-thread stop() and the
    subsequent close() must not touch freed state."""

    def test_cross_thread_stop_unblocks_acquire(self, tmp_path):
        import threading
        import time as _time

        from cudacam_tpu.native import FramePump, write_rawv

        frames = np.zeros((2, 8, 8), np.uint8)
        path = write_rawv(str(tmp_path / "s.rawv"), frames)
        pump = FramePump(path, ring_slots=2)
        # Drain both frames; next acquire would block forever on a looped
        # stream — use loop=True to force the blocking case.
        pump.close()

        pump = FramePump(path, loop=True, ring_slots=2)
        seen = []

        def consumer():
            while True:
                v = pump.acquire()
                if v is None:
                    break
                seen.append(1)
                if len(seen) >= 8:
                    _time.sleep(0.05)  # let the ring refill, then block
        t = threading.Thread(target=consumer)
        t.start()
        _time.sleep(0.2)
        pump.stop()          # cross-thread: must wake the blocked acquire
        t.join(timeout=5)
        assert not t.is_alive()
        assert len(seen) >= 8
        pump.close()         # owner thread destroys after consumer exited

    def test_stop_idempotent_and_close_after_stop(self, tmp_path):
        from cudacam_tpu.native import FramePump, write_rawv

        frames = np.zeros((1, 4, 4), np.uint8)
        path = write_rawv(str(tmp_path / "t.rawv"), frames)
        pump = FramePump(path, ring_slots=2)
        pump.stop()
        pump.stop()
        pump.close()

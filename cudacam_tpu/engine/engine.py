"""CannyEngine — the pipeline orchestrator.

The analog of the reference's two host layers in one:
``cvp::cvPipeline`` (the CUDA-free facade, src/cvp/cvPipeline.{hpp,cpp}) and
``cvp::cuda::CannyEdge`` (the host orchestrator, src/cvp/cannyEdgeH.{hpp,cu}).

Responsibilities mirrored from the reference:
- spec-locked init: frames must match the construction-time dimensions and
  channel count (cannyEdgeH.cu:124-130), with input validation on type
  (cvPipeline.cpp:27-36 accepts 8UC3/8UC1 only);
- run-to-stage-k cumulative execution (cannyEdgeH.cu:49-120);
- runtime threshold get/set with low <= high clamping (cannyEdgeH.hpp:25-28);
- toggleable per-stage profiling into a named-timer table
  (cannyEdgeH.cu:409-430, default ON there; default OFF here since profiling
  forces per-stage device synchronisation).

Differences from the reference:
- thresholds are *traced arguments* of one compiled executable, so slider
  moves never recompile or relaunch anything;
- unprofiled runs execute ONE compiled XLA program per frame instead of
  nine hand-launched kernels;
- batched frames (B, H, W, C) are first-class via vmap (BASELINE.json
  config 4: multi-camera streams).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.stages import CANNY_STAGE_NAMES, CannyStage
from cudacam_tpu.utils.logging import get_logger
from cudacam_tpu.utils.timer import TimerManager

log = get_logger("engine")

ArrayLike = Union[np.ndarray, jax.Array]


class _ResilientJit:
    """jit wrapper that routes around a jax 0.9 dispatch failure seen in
    this project's earlier runs on another accelerator runtime: after
    another executable with identical HLO exists in the process, a jit
    object's C++ fastpath entry can go inconsistent and every dispatch
    raises "Execution supplied 3 buffers but compiled program expected 4
    buffers" (the python path and a fresh AOT compile of the very same
    function keep working). It has not been seen on the GPU runtime, and
    the wrapper costs nothing while the error does not occur. On it the
    wrapper permanently switches the affected argument signature to an
    AOT-compiled executable (``fn.lower(...).compile()``), which bypasses
    the fastpath cache entirely. Everything else — tracing, jit cache
    stability (``_cache_size``), attributes — delegates to the real jit."""

    def __init__(self, fn) -> None:
        self._fn = fn
        self._aot: Dict[tuple, Callable] = {}

    @staticmethod
    def _sig(args) -> tuple:
        return tuple(
            (getattr(a, "shape", None), str(getattr(a, "dtype", type(a))))
            for a in args
        )

    def __call__(self, *args):
        if any(isinstance(a, jax.core.Tracer) for a in args):
            # Under an outer trace (vmap/jit): tracers must go through the
            # real jit (an AOT Compiled can't take tracers), and the
            # fastpath bug is a dispatch-time issue that can't occur here.
            return self._fn(*args)
        c = self._aot.get(self._sig(args)) if self._aot else None
        if c is not None:
            return c(*args)
        try:
            return self._fn(*args)
        except ValueError as e:
            if "buffers but compiled program expected" not in str(e):
                raise
            log.warning(
                "jit fastpath inconsistency (%s); switching this signature "
                "to an AOT-compiled executable", e
            )
            c = self._fn.lower(*args).compile()
            self._aot[self._sig(args)] = c
            return c(*args)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def _rjit(fn) -> _ResilientJit:
    return _ResilientJit(jax.jit(fn))


def _trace_cfg(cfg: CannyConfig) -> CannyConfig:
    """Canonicalize away fields that do NOT affect the traced computation
    (thresholds are runtime arguments), so configs differing only in those
    share one cache entry: two distinct jit objects wrapping the same
    computation are what trips the dispatch failure _ResilientJit
    describes."""
    import dataclasses

    return dataclasses.replace(cfg, low_threshold=0, high_threshold=0)


def _compiled_to_stage(
    cfg: CannyConfig, stage: CannyStage, batched: bool
) -> Callable:
    return _compiled_to_stage_cached(_trace_cfg(cfg), stage, batched)


@functools.lru_cache(maxsize=None)
def _compiled_to_stage_cached(
    cfg: CannyConfig, stage: CannyStage, batched: bool
) -> Callable:
    """Process-global compiled pipeline, shared by every engine with this
    config: see the cache-sharing note in CannyEngine."""
    base = lambda f, lo, hi: xla_ops.canny_to_stage(f, lo, hi, cfg, stage)
    if batched:
        base = jax.vmap(base, in_axes=(0, None, None))
    return _rjit(base)


def _compiled_all_stages(cfg: CannyConfig, batched: bool) -> Callable:
    return _compiled_all_stages_cached(_trace_cfg(cfg), batched)


@functools.lru_cache(maxsize=None)
def _compiled_all_stages_cached(cfg: CannyConfig, batched: bool) -> Callable:
    base = lambda f, lo, hi: xla_ops.canny_all_stages(f, lo, hi, cfg)
    if batched:
        base = jax.vmap(base, in_axes=(0, None, None))
    return _rjit(base)


def _compiled_threshold_sweep(cfg: CannyConfig, k: int) -> Callable:
    return _compiled_threshold_sweep_cached(_trace_cfg(cfg), k)


@functools.lru_cache(maxsize=None)
def _compiled_threshold_sweep_cached(cfg: CannyConfig, k: int) -> Callable:
    del k  # cache key only: K (low, high) pairs -> distinct trace shapes
    return _rjit(lambda f, lo, hi: xla_ops.threshold_sweep(f, lo, hi, cfg))


# Profiling-mode stage steps, each cached on exactly the parameters its
# trace depends on, so no two jit objects ever wrap the same computation.


@functools.lru_cache(maxsize=None)
def _step_mono() -> Callable:
    return _rjit(xla_ops.rgb2mono)


@functools.lru_cache(maxsize=None)
def _step_gaussian(kernel_size: int) -> Callable:
    return _rjit(
        functools.partial(xla_ops.gaussian_blur, kernel_size=kernel_size)
    )


@functools.lru_cache(maxsize=None)
def _step_sobel() -> Callable:
    return _rjit(xla_ops.sobel_sums)


@functools.lru_cache(maxsize=None)
def _step_nms(disp_coeff: int, norm: str) -> Callable:
    # Returns (display buffer, keep mask): the keep mask is the expensive
    # part and is reused by THRESH, so its cost is attributed once, here.
    return _rjit(
        lambda sx, sy: (
            lambda keep: (
                jnp.where(
                    keep,
                    xla_ops.nms_magnitude_u8(sx, sy, disp_coeff, norm),
                    jnp.uint8(0),
                ),
                keep,
            )
        )(xla_ops.nms_keep_mask(sx, sy, norm))
    )


@functools.lru_cache(maxsize=None)
def _step_thresh(parity: str, norm: str) -> Callable:
    # Threshold compare only, in the configured parity domain (the keep
    # mask comes from the NMS step).
    return _rjit(
        (lambda nms, sx, sy, keep, lo, hi:
         xla_ops.double_threshold(nms, lo, hi))
        if parity == "reference"
        else (lambda nms, sx, sy, keep, lo, hi:
              xla_ops.double_threshold_opencv(sx, sy, keep, lo, hi, norm))
    )


@functools.lru_cache(maxsize=None)
def _step_hyster(max_iters: int, inner_steps: int, scan_after: int) -> Callable:
    return _rjit(
        functools.partial(
            xla_ops.hysteresis,
            max_iters=max_iters,
            inner_steps=inner_steps,
            scan_after=scan_after,
        )
    )


@functools.lru_cache(maxsize=None)
def _step_gradient_display(disp_coeff: int, norm: str) -> Callable:
    return _rjit(
        functools.partial(
            xla_ops.nms_magnitude_u8, grad_coeff=disp_coeff, norm=norm
        )
    )


def _compiled_stage_steps(cfg: CannyConfig) -> Dict[str, Callable]:
    """Per-stage jitted steps for profiling mode (each synchronised,
    mirroring the reference's cudaEvent bracketing, cannyEdgeH.cu:409-430)."""
    disp_coeff = xla_ops._display_coeff(cfg)
    return {
        "mono": _step_mono(),
        "gaussian": _step_gaussian(cfg.kernel_size),
        "sobel": _step_sobel(),
        "nms": _step_nms(disp_coeff, cfg.norm),
        "thresh": _step_thresh(cfg.parity, cfg.norm),
        "hyster": _step_hyster(
            cfg.max_hysteresis_iters,
            cfg.hysteresis_inner_steps,
            cfg.hysteresis_scan_after,
        ),
        "gradient_display": _step_gradient_display(disp_coeff, cfg.norm),
    }


class ThresholdControls:
    """Runtime threshold accessors shared by every engine flavor: clamping
    identical to the reference setters, which force low <= high
    (cannyEdgeH.hpp:25-28) with the parity-aware cap, plus a cached pair of
    device-resident scalars so the hot loop never re-uploads them (the
    reference instead re-passes kernel args each launch,
    cannyEdgeH.cu:289-291). Requires ``self._cfg``."""

    def _init_thresholds(self, config: CannyConfig) -> None:
        self._low = config.low_threshold
        self._high = config.high_threshold
        self._thresh_dev: Optional[tuple] = None

    def get_low_threshold(self) -> int:
        return self._low

    def get_high_threshold(self) -> int:
        return self._high

    def set_low_threshold(self, low: int) -> None:
        self._low = max(0, min(int(low), self._high))

    def set_high_threshold(self, high: int) -> None:
        self._high = min(self._cfg.threshold_cap, max(int(high), self._low))

    def _thresholds(self) -> tuple:
        """Device-resident threshold scalars, cached BY VALUE: the cache
        entry carries the (low, high) it was built from and is rebuilt
        whenever the current values differ. A None-sentinel invalidation
        would race with concurrent setters (the /set endpoint and key
        controller run on other threads): the run loop could overwrite a
        concurrent invalidation and serve stale thresholds forever."""
        cached = self._thresh_dev
        lo, hi = self._low, self._high
        if cached is None or cached[0] != lo or cached[1] != hi:
            cached = (
                lo,
                hi,
                jax.device_put(jnp.int32(lo)),
                jax.device_put(jnp.int32(hi)),
            )
            self._thresh_dev = cached
        return cached[2], cached[3]


class CannyEngine(ThresholdControls):
    """Spec-locked, jit-compiled Canny pipeline engine."""

    def __init__(
        self,
        config: CannyConfig,
        profiling: bool = False,
        timers: Optional[TimerManager] = None,
    ) -> None:
        self._cfg = config
        self._profiling = profiling
        #: 'stages' | 'cumulative' | 'device' — see _process_profiled
        #: (device = profiler device-lane sampling, _process_profiled_device).
        self.profiling_mode = "stages"
        self._timers = timers or TimerManager.get()
        self._init_thresholds(config)
        # One jit cache entry per (final_stage, batched); thresholds traced.
        self._to_stage_fns: Dict[tuple, Callable] = {}
        self._all_stages_fns: Dict[bool, Callable] = {}
        self._stage_step_fns: Optional[Dict[str, Callable]] = None
        self._profile_warmed: set = set()
        for name in CANNY_STAGE_NAMES.values():
            self._timers.create_timer(name)
        log.debug("engine created: %s", config)

    # -- properties / reference accessors ---------------------------------

    @property
    def config(self) -> CannyConfig:
        return self._cfg

    def is_profiling_enabled(self) -> bool:
        return self._profiling

    def set_profiling(self, enabled: bool) -> None:
        """Toggle per-stage timing (reference cannyEdgeH.hpp:31)."""
        self._profiling = bool(enabled)

    @property
    def timers(self) -> TimerManager:
        return self._timers

    # -- validation --------------------------------------------------------

    def _validate(self, frame: ArrayLike) -> tuple[jnp.ndarray, bool]:
        """Spec lock + type checks (cvPipeline.cpp:27-36; cannyEdgeH.cu:124-130).
        Returns (device array, batched?)."""
        if frame is None or (hasattr(frame, "size") and frame.size == 0):
            raise ValueError("Cannot process empty frame")
        arr = jnp.asarray(frame)
        if arr.dtype != jnp.uint8:
            raise ValueError(f"Only uint8 frames supported, got {arr.dtype}")
        c = self._cfg.channels
        expected = (self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        if arr.shape == expected:
            return arr, False
        if arr.ndim == len(expected) + 1 and arr.shape[1:] == expected:
            return arr, True
        raise ValueError(
            f"Frame specs differ from initialization: got {arr.shape}, "
            f"expected {expected} or (B,)+{expected}"
        )

    # -- compiled function caches ------------------------------------------
    # Per-engine dicts only memoize lookups into the PROCESS-GLOBAL caches
    # above: identical configs lower to identical programs, so engines share
    # one jit callable per (config, stage, batched). Sharing saves
    # recompiles when many engines exist in one process, and avoids the
    # duplicate-jit dispatch failure described in _ResilientJit.

    def _get_to_stage(self, stage: CannyStage, batched: bool) -> Callable:
        key = (stage, batched)
        fn = self._to_stage_fns.get(key)
        if fn is None:
            fn = _compiled_to_stage(self._cfg, stage, batched)
            self._to_stage_fns[key] = fn
        return fn

    def _get_all_stages(self, batched: bool) -> Callable:
        fn = self._all_stages_fns.get(batched)
        if fn is None:
            fn = _compiled_all_stages(self._cfg, batched)
            self._all_stages_fns[batched] = fn
        return fn

    def _get_stage_steps(self) -> Dict[str, Callable]:
        if self._stage_step_fns is None:
            self._stage_step_fns = _compiled_stage_steps(self._cfg)
        return self._stage_step_fns


    # -- execution ----------------------------------------------------------

    def process(
        self,
        frame: ArrayLike,
        final_stage: CannyStage = CannyStage.HYSTER,
    ) -> jax.Array:
        """Run stages 0..final_stage, returning that stage's uint8 display
        buffer on device (the PBO analog stays device-resident)."""
        arr, batched = self._validate(frame)
        final_stage = CannyStage(final_stage)
        lo, hi = self._thresholds()
        if not self._profiling:
            return self._get_to_stage(final_stage, batched)(arr, lo, hi)
        return self._process_profiled(arr, batched, final_stage, lo, hi)

    def _process_profiled(
        self, arr: jax.Array, batched: bool, final_stage: CannyStage, lo, hi
    ) -> jax.Array:
        """Per-stage timed execution (the reference's profiling path also
        syncs per stage, cannyEdgeH.cu:420-429). Three modes:

        - ``stages`` (the default): run the stage-split XLA ops, each
          synchronised and timed directly;
        - ``cumulative``: run the cumulative run-to-stage-k programs that
          unprofiled users run and attribute each stage the time increment
          t(k) - t(k-1);
        - ``device``: like ``cumulative``, but each increment is the
          profiler's device busy time instead of the host clock (see
          _process_profiled_device)."""
        mode = self.profiling_mode
        if mode == "device":
            return self._process_profiled_device(
                arr, batched, final_stage, lo, hi
            )
        if mode == "cumulative":
            return self._process_profiled_cumulative(
                arr, batched, final_stage, lo, hi
            )
        steps = self._get_stage_steps()
        t = self._timers
        names = CANNY_STAGE_NAMES

        def timed(stage: CannyStage, fn, *args):
            with t.time(names[stage]):
                out = fn(*args)
                jax.block_until_ready(out)
            return out

        run = (lambda f: jax.vmap(f)) if batched else (lambda f: f)

        mono = timed(CannyStage.MONO, run(steps["mono"]), arr)
        if final_stage == CannyStage.MONO:
            return mono
        blur = timed(CannyStage.GAUSSIAN, run(steps["gaussian"]), mono)
        if final_stage == CannyStage.GAUSSIAN:
            return blur
        # The reference times sobel+gradSlope together as "3/6" (cannyEdgeH.cu:245-264).
        with t.time(names[CannyStage.GRADIENT]):
            sum_x, sum_y = run(steps["sobel"])(blur)
            jax.block_until_ready((sum_x, sum_y))
        if final_stage == CannyStage.GRADIENT:
            return run(steps["gradient_display"])(sum_x, sum_y)
        nms, keep = timed(
            CannyStage.NMS,
            (jax.vmap(steps["nms"]) if batched else steps["nms"]),
            sum_x,
            sum_y,
        )
        if final_stage == CannyStage.NMS:
            return nms
        thr_fn = steps["thresh"]
        if batched:
            thr_fn = jax.vmap(thr_fn, in_axes=(0, 0, 0, 0, None, None))
        thresh = timed(CannyStage.THRESH, thr_fn, nms, sum_x, sum_y, keep, lo, hi)
        if final_stage == CannyStage.THRESH:
            return thresh
        hys_fn = steps["hyster"]
        if batched:
            hys_fn = jax.vmap(hys_fn)
        return timed(CannyStage.HYSTER, hys_fn, thresh)

    def _process_profiled_cumulative(
        self, arr: jax.Array, batched: bool, final_stage: CannyStage, lo, hi
    ) -> jax.Array:
        """Profiling on the production programs: run the cumulative
        run-to-stage-k programs (the exact programs unprofiled users run)
        and attribute stage k the increment t(k) - t(k-1), clamped at 0.
        Costs ~2x one frame (k programs) — profiling mode is allowed to.
        The reference's analog relaunches its kernel chain per stage too
        (cannyEdgeH.cu:49-120 cumulative switch).

        The first profiled frame warms (compiles + runs) every stage
        program OUTSIDE the timed loop: enabling profiling live would
        otherwise freeze the stream for several compiles and record
        compile time as stage time.
        """
        import time as _time

        key = ("cumwarm", batched, final_stage)
        if key not in self._profile_warmed:
            for stage in CannyStage:
                if stage > final_stage:
                    break
                jax.block_until_ready(
                    self._get_to_stage(stage, batched)(arr, lo, hi)
                )
            self._profile_warmed.add(key)

        names = CANNY_STAGE_NAMES
        prev = 0.0
        out = None
        for stage in CannyStage:
            if stage > final_stage:
                break
            fn = self._get_to_stage(stage, batched)
            t0 = _time.perf_counter()
            out = fn(arr, lo, hi)
            jax.block_until_ready(out)
            dt = (_time.perf_counter() - t0) * 1e3
            self._timers.add_time(names[stage], max(0.0, dt - prev))
            prev = dt
        return out

    def _process_profiled_device(
        self, arr: jax.Array, batched: bool, final_stage: CannyStage, lo, hi
    ) -> jax.Array:
        """Profiling from the device's own clock: per-stage times come from
        the profiler's device lanes (utils/devtime.py), not the host clock,
        so host dispatch and synchronisation costs are left out.
        Mechanics: the FIRST profiled frame per (batch, stage) key
        samples each cumulative run-to-stage-k program under its own
        profiler trace (a one-time ~2 s/stage capture; separate traces
        because the executables share a name and would aggregate) and
        records the t(k) - t(k-1) increments; subsequent frames run the
        production program untraced, so streaming stays at full speed and
        the table shows the device-lane sample. On CPU (no device lane)
        the sample falls back to the host clock. Re-enable via
        ``timers.reset()`` + dropping the sample key to re-sample."""
        key = ("devsample", batched, final_stage)
        if key not in self._profile_warmed:
            names = CANNY_STAGE_NAMES
            from cudacam_tpu.utils.devtime import device_time_ms_per_call

            import time as _time

            prev = 0.0
            for stage in CannyStage:
                if stage > final_stage:
                    break
                fn = self._get_to_stage(stage, batched)
                jax.block_until_ready(fn(arr, lo, hi))  # warm/compile
                dev = device_time_ms_per_call(
                    lambda: jax.block_until_ready(fn(arr, lo, hi)), calls=3
                )
                if dev is None:  # CPU: no device lane, use the host clock
                    t0 = _time.perf_counter()
                    jax.block_until_ready(fn(arr, lo, hi))
                    dev = (_time.perf_counter() - t0) * 1e3
                self._timers.add_time(names[stage], max(0.0, dev - prev))
                prev = dev
            self._profile_warmed.add(key)
        return self._get_to_stage(final_stage, batched)(arr, lo, hi)

    def process_all(self, frame: ArrayLike) -> Dict[str, jax.Array]:
        """Run everything, returning all stage buffers (the reference keeps
        every intermediary for display, README.md:22)."""
        arr, batched = self._validate(frame)
        lo, hi = self._thresholds()
        return self._get_all_stages(batched)(arr, lo, hi)

    def warmup(self, final_stage: CannyStage = CannyStage.HYSTER, batch: int = 0) -> None:
        """Compile ahead of the first real frame."""
        c = self._cfg.channels
        shape = (self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        if batch:
            shape = (batch,) + shape
        dummy = jnp.zeros(shape, jnp.uint8)
        jax.block_until_ready(self.process(dummy, final_stage))
        if self._profiling:
            # Drop the warmup samples: they time trace+compile, not kernels,
            # and would dominate the per-stage averages. The device-lane
            # sample keys are dropped too so the first REAL frame
            # re-samples (its table entries were just reset with the rest).
            self._timers.reset()
            self._profile_warmed = {
                k for k in self._profile_warmed if k[0] != "devsample"
            }

    def profiling_table(self) -> str:
        return self._timers.table()

    def threshold_sweep(self, frame: ArrayLike, lows, highs):
        """Edge maps + counts for K (low, high) pairs in one compiled
        program (see xla_ops.threshold_sweep)."""
        arr, batched = self._validate(frame)
        if batched:
            raise ValueError("threshold_sweep takes a single frame")
        lows = np.asarray(lows, np.int32)
        highs = np.asarray(highs, np.int32)
        if lows.shape != highs.shape or lows.ndim != 1:
            raise ValueError("lows/highs must be equal-length 1D")
        k = int(lows.shape[0])
        fn = _compiled_threshold_sweep(self._cfg, k)
        return fn(arr, jnp.asarray(lows), jnp.asarray(highs))

    @contextlib.contextmanager
    def trace(self, logdir: str):
        """Capture a device profile of everything run inside the context
        (TensorBoard/XProf format) — the deep-dive layer under the
        per-stage timer table, reference cannyEdgeH.cu:409-430."""
        with jax.profiler.trace(logdir):
            yield

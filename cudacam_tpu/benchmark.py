"""Benchmark: full six-stage Canny pipeline cost on a 1080p frame, on a GPU.

Baseline: the reference CUDA app reports ~6 ms/frame for "the entire CUDA
process" on a GTX 1650 at 1080p (reference README.md:5; BASELINE.md).

``main`` prints exactly ONE JSON line:
  {"metric": ..., "value": <device ms/frame>, "unit": "ms",
   "vs_baseline": <speedup>, "wall_ms_per_frame": ...,
   "platform": "gpu", "device_kind": ..., "device_count": ...}
vs_baseline > 1 means faster than the reference's 6 ms.

Methodology: a streaming loop of distinct device-resident frames. The
headline value is device busy time per frame from a profiler trace
(utils/devtime.py); the host wall clock around ``block_until_ready`` is
reported beside it. A measurement needs the card: on any other platform
the benchmark exits non-zero instead of reporting a host number.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

from cudacam_tpu.io.sources import make_scene, make_spiral_thresh

BASELINE_MS = 6.0


def require_gpu():
    """The JAX devices, after checking that they are GPUs (SystemExit 2
    otherwise: no measurement falls back to the host)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"benchmark needs a GPU; JAX platform is {devs[0].platform!r}"
        )
    return devs


def _wall_ms(run_once, passes: int, frames_per_pass: int) -> float:
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        run_once()
        times.append((time.perf_counter() - t0) * 1e3 / frames_per_pass)
    return statistics.median(times)


def _measure_ms_per_frame(run_once, n_frames: int, passes: int = 4) -> tuple:
    """(device_ms, wall_ms) per frame for one warm streaming pass."""
    import jax

    from cudacam_tpu.utils.devtime import device_time_ms_per_call

    jax.block_until_ready(run_once())  # warm once more
    wall = _wall_ms(run_once, max(2, passes - 1), n_frames)
    dev = device_time_ms_per_call(run_once, calls=passes) / n_frames
    return dev, wall


def main() -> None:
    import jax

    from cudacam_tpu import CannyConfig
    from cudacam_tpu.engine import CannyEngine

    devs = require_gpu()
    h, w = 1080, 1920
    engine = CannyEngine(CannyConfig(height=h, width=w))
    engine.warmup()

    # Distinct device-resident frames, streamed back-to-back — the
    # reference's own number is per-frame processing time inside a live
    # streaming loop (README.md:5), display never leaving the GPU.
    n_stream = 8
    frames = [
        jax.device_put(make_scene(h, w, seed=s)) for s in range(n_stream)
    ]

    def run_once():
        out = None
        for f in frames:
            out = engine.process(f)
        jax.block_until_ready(out)
        return out

    run_once()  # warm every input's dispatch path
    dev, wall = _measure_ms_per_frame(run_once, n_stream, passes=6)
    print(
        json.dumps(
            {
                "metric": "canny_1080p_device_ms_per_frame",
                "value": dev,
                "unit": "ms",
                "vs_baseline": BASELINE_MS / dev,
                "wall_ms_per_frame": wall,
                "platform": devs[0].platform,
                "device_kind": devs[0].device_kind,
                "device_count": len(devs),
            }
        )
    )


def full_table() -> None:
    """Extended table — device-time and wall columns per configuration —
    printed as markdown. The single-line contract stays in main()."""
    import jax
    import jax.numpy as jnp

    from cudacam_tpu import CannyConfig, CannyStage
    from cudacam_tpu.engine import CannyEngine
    from cudacam_tpu.io.sources import make_spiral_frame
    from cudacam_tpu.ops.bitpack import hysteresis_packed

    devs = require_gpu()
    rows = []

    def add(name, dev_ms, wall_ms, note=""):
        rows.append((name, dev_ms, wall_ms, BASELINE_MS / dev_ms, note))
        print(f"  {name:44s} dev={dev_ms:9.4f} wall={wall_ms:9.4f} ms "
              f"{BASELINE_MS / dev_ms:8.1f}x  {note}", flush=True)

    def bench_engine(eng, frames, name, note="", stage=None, passes=4):
        def run_once():
            out = None
            for f in frames:
                out = (eng.process(f) if stage is None
                       else eng.process(f, stage))
            jax.block_until_ready(out)
        run_once()
        dev, wall = _measure_ms_per_frame(run_once, len(frames), passes)
        add(name, dev, wall, note)

    def bench_call(fn, n_frames, name, note=""):
        def run_once():
            jax.block_until_ready(fn())
        run_once()
        dev, wall = _measure_ms_per_frame(run_once, n_frames)
        add(name, dev, wall, note)

    h, w = 1080, 1920
    cfg = CannyConfig(height=h, width=w)
    frames = [jax.device_put(make_scene(h, w, seed=s)) for s in range(8)]
    eng = CannyEngine(cfg)
    eng.warmup()
    bench_engine(eng, frames, "1080p stream ms/frame")

    # Per-stage cumulative (run-to-stage-k).
    for stage in CannyStage:
        eng.warmup(stage)
        bench_engine(eng, frames, f"1080p to stage {stage.name}", stage=stage)

    # Config 1: VGA grayscale frame (the reference's minimal workload).
    eng_vga = CannyEngine(CannyConfig(height=480, width=640, channels=1))
    fv = [jax.device_put(make_scene(480, 640, seed=s)[..., 0].copy())
          for s in range(8)]
    eng_vga.warmup()
    bench_engine(eng_vga, fv, "VGA (480x640) grayscale stream ms/frame")

    # Config 2: every intermediary stage buffer kept (process_all).
    eng_all = CannyEngine(cfg)
    bench_call(lambda: [eng_all.process_all(f)["hyster"] for f in frames[:4]],
               4, "1080p all-stage outputs ms/frame",
               "keeps every display buffer (README.md:22 analog)")

    # Config 3: kernel-size / norm variants.
    for ks, norm in ((3, "l2"), (7, "l2"), (5, "l1")):
        engv = CannyEngine(CannyConfig(height=h, width=w, kernel_size=ks,
                                       norm=norm))
        engv.warmup()
        bench_engine(engv, frames[:4],
                     f"1080p ks={ks} norm={norm} stream ms/frame")

    # Batched multi-camera streams (config 4): identical frames measure
    # batching itself; the mixed row varies convergence depth per frame.
    for b, mixed in ((4, False), (8, False), (8, True)):
        fsrc = ([make_scene(h, w, seed=100 + s) for s in range(b)] if mixed
                else [make_scene(h, w, seed=0)] * b)
        batch = jax.device_put(np.stack(fsrc))
        engb = CannyEngine(cfg)
        engb.warmup(batch=b)
        tag = "mixed scenes" if mixed else "fixed scene"
        bench_call(lambda: engb.process(batch), b,
                   f"1080p batched x{b} ({tag}) ms/frame")

    # Threshold sweep (config 3): K (low, high) pairs in one program.
    K = 16
    lows = np.linspace(5, 60, K).astype(np.int32)
    highs = np.linspace(20, 180, K).astype(np.int32)
    for label, hh, ww in (("1080p", h, w), ("4K", 2160, 3840)):
        eng_sw = CannyEngine(CannyConfig(height=hh, width=ww))
        fr = jax.device_put(make_scene(hh, ww, seed=0))
        bench_call(lambda: eng_sw.threshold_sweep(fr, lows, highs), 1,
                   f"{label} threshold sweep K={K}")

    # Worst-case hysteresis: a frame-long spiral candidate chain that runs
    # to the 100-round cap (the reference's analog is its 100-relaunch
    # belt, cannyEdgeH.cu:313).
    spiral = jax.device_put(jnp.asarray(make_spiral_thresh(h, w)))
    hyst = jax.jit(lambda t: hysteresis_packed(
        t, max_iters=100, dilate_steps=cfg.hysteresis_inner_steps,
        scan_after=cfg.hysteresis_scan_after))
    bench_call(lambda: hyst(spiral), 1,
               "hysteresis worst case (1080p spiral thresh map)")
    for hh, ww, label in ((h, w, "1080p"), (2160, 3840, "4K")):
        eng_wc = CannyEngine(CannyConfig(height=hh, width=ww))
        sp = jax.device_put(make_spiral_frame(hh, ww))
        eng_wc.warmup()
        bench_call(lambda: eng_wc.process(sp), 1,
                   f"{label} worst case through engine")

    # Mega-frames (the BASELINE.json axis of scaling frame size).
    for hm, wm, label in ((2160, 3840, "4K"), (4320, 7680, "8K")):
        engm = CannyEngine(CannyConfig(height=hm, width=wm))
        fm = [jax.device_put(make_scene(hm, wm, seed=s)) for s in range(2)]
        engm.warmup()
        bench_engine(engm, fm, f"{label} ({hm}x{wm}) stream ms/frame")

    print()
    print(f"Device: {devs[0].device_kind} x{len(devs)}. Baseline: reference "
          "CUDA app, ~6 ms/frame at 1080p on a GTX 1650 (its README).")
    print()
    print("| Benchmark | device ms/frame | wall ms/frame | vs 6 ms | Note |")
    print("|---|---|---|---|---|")
    for name, dev_ms, wall_ms, speedup, note in rows:
        print(f"| {name} | {dev_ms} | {wall_ms} | {speedup:.1f}x | {note} |")


def cli_entry() -> None:
    from cudacam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if "--full" in sys.argv:
        full_table()
    else:
        main()


if __name__ == "__main__":
    cli_entry()

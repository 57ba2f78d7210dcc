#!/usr/bin/env python
"""Smoke run of the Canny pipeline on an NVIDIA GPU, checked against the
NumPy oracle.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --cards 4   # four cards: the sharded path only

Drives the main path through the entry points a user calls (CannyEngine,
CannyApp) at the reference's deployment size, 1080p BGR camera frames, plus
the variants, batch, sweep and mega-frame configurations, and compares every
edge map bit-for-bit with ``cudacam_tpu.ops.numpy_oracle`` (capped spiral:
``numpy_oracle.hysteresis_capped``). Every phase runs in this one process and
prints one line; any failed check raises and ends the run with a non-zero
exit. The first lines name the card (``nvidia-smi``, run as a child process
that does not touch JAX), its power limit, the JAX version, ``XLA_FLAGS`` and
the compile-cache directory. Times are host wall clock around
``block_until_ready`` unless named ``device_busy`` (profiler trace,
``cudacam_tpu.utils.devtime``); ``peak_bytes`` is the process's
``peak_bytes_in_use`` so far. The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

On a platform other than the GPU the script exits non-zero before any phase
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import numpy as np

from cudacam_tpu import CannyConfig
from cudacam_tpu.app import CannyApp
from cudacam_tpu.engine import CannyEngine, ShardedCannyEngine
from cudacam_tpu.io import open_source
from cudacam_tpu.io.sources import make_scene, make_spiral_frame
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.parallel import make_mesh
from cudacam_tpu.utils.compile_cache import enable_compile_cache
from cudacam_tpu.utils.devtime import device_time_ms_per_call

HD = (1080, 1920)
#: Threshold pairs of the K=16 sweep (the benchmark's grid).
SWEEP_LOWS = np.linspace(5, 60, 16).astype(np.int32)
SWEEP_HIGHS = np.linspace(20, 180, 16).astype(np.int32)
#: uint8 buffers of process_all: bit-exact against the oracle.
EXACT_KEYS = ("mono", "gaussian", "gradient_display", "nms", "thresh", "hyster")
#: Bounds on the float display buffers (no pixel decision reads them):
#: grad = coeff * sqrt(m) with m exact in float32, so only sqrt's rounding
#: can differ (relative bound: one float32 ulp, 2**-23, with a factor 2 of
#: margin); slope = atan2 differs by a few ulp between math libraries
#: (absolute bound: 4 ulp of pi, 4 * 2**-22); float2uchar(grad) can move by
#: at most one step where grad's rounding crosses an integer.
GRAD_RTOL = 2.0**-22
SLOPE_ATOL = 4 * 2.0**-22


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_info() -> list:
    """``nvidia-smi`` name and power limit of every card, one per line."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def wall_ms(fn, per: int = 1, reps: int = 3) -> float:
    """Median host ms per item of ``fn()`` (which must block)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3 / per)
    return statistics.median(times)


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def oracle_hyster(frame, cfg: CannyConfig, low=None, high=None):
    return oracle.canny_pipeline(
        frame,
        low=cfg.low_threshold if low is None else low,
        high=cfg.high_threshold if high is None else high,
        kernel_size=cfg.kernel_size, grad_coeff=cfg.grad_coeff,
        norm=cfg.norm, parity=cfg.parity,
    )["hyster"]


def assert_exact(got, want, what: str) -> None:
    got = np.asarray(got)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    n = int((got != want).sum())
    check(n == 0, f"{what}: {n} pixels differ from the oracle")


# -- single-card phases -------------------------------------------------------


def phase_stream(h: int = HD[0], w: int = HD[1], n: int = 8) -> dict:
    """``n`` distinct scenes through ``CannyEngine.process``, each checked
    against the oracle; wall and device-busy ms/frame of the stream."""
    cfg = CannyConfig(height=h, width=w)
    eng = CannyEngine(cfg)
    eng.warmup()
    host = [make_scene(h, w, seed=s) for s in range(n)]
    frames = [jax.device_put(f) for f in host]

    def run():
        out = [eng.process(f) for f in frames]
        jax.block_until_ready(out)
        return out

    outs = run()
    for i, (f, o) in enumerate(zip(host, outs)):
        assert_exact(o, oracle_hyster(f, cfg), f"stream frame {i}")
    wall = wall_ms(run, per=n)
    busy = device_time_ms_per_call(run, calls=3)
    busy = None if busy is None else busy / n
    return {
        "frames": n, "bit_exact": f"{n}/{n}", "wall_ms_per_frame": wall,
        "device_busy_ms_per_frame": busy,
        "device_busy_share": None if busy is None else busy / wall,
        "peak_bytes": peak_bytes(),
    }


def phase_served(h: int = HD[0], w: int = HD[1], n: int = 60) -> dict:
    """CannyApp over a synthetic camera, as ``python -m cudacam_tpu run``
    drives it: every frame is generated on the host and uploaded."""
    source = open_source(f"synthetic:{h}x{w}", n_frames=n)
    source.start()
    with CannyApp(source, CannyConfig(height=h, width=w)) as app:
        app.warmup()
        t0 = time.perf_counter()
        done = app.run(n)
        jax.block_until_ready(app.ring.latest())
        dt = time.perf_counter() - t0
        check(done == n, f"served {done} of {n} frames")
        assert_exact(app.ring.latest_np(),
                     oracle_hyster(app._last_input, app.engine.config),
                     "served last frame")
    t0 = time.perf_counter()
    make_scene(h, w, seed=0, t=1.0)
    source_ms = (time.perf_counter() - t0) * 1e3
    return {
        "frames": n, "fps": n / dt, "wall_ms_per_frame": dt * 1e3 / n,
        "synthetic_source_ms_per_frame": source_ms, "peak_bytes": peak_bytes(),
    }


def phase_all_stages(h: int = HD[0], w: int = HD[1]) -> dict:
    """``process_all``: every uint8 stage buffer bit-exact; the float
    display buffers reported as (pixels that differ, largest difference)."""
    cfg = CannyConfig(height=h, width=w)
    eng = CannyEngine(cfg)
    frame = make_scene(h, w, seed=1)
    fd = jax.device_put(frame)
    got = jax.block_until_ready(eng.process_all(fd))
    want = oracle.canny_pipeline(frame)
    for k in EXACT_KEYS:
        assert_exact(got[k], want[k], f"all-stages {k}")
    got = dict(got, float2uchar_grad=xla_ops.float2uchar(got["grad"]))
    want = dict(want, float2uchar_grad=oracle.float2uchar(want["grad"]))
    floats = {}
    for k in ("sobel_x", "sobel_y", "grad", "slope", "float2uchar_grad"):
        g = np.asarray(got[k]).astype(np.float64)
        r = want[k].astype(np.float64)
        d = np.abs(g - r)
        floats[k] = (int((d > 0).sum()), float(d.max()))
    # Sobel planes are integers / 8: exact in float32 on every platform.
    check(floats["sobel_x"][0] == 0 and floats["sobel_y"][0] == 0,
          f"sobel display planes differ: {floats}")
    grad_rel = np.abs(np.asarray(got["grad"], np.float64) - want["grad"]) / (
        np.maximum(want["grad"], 1.0))
    check(float(grad_rel.max()) <= GRAD_RTOL, f"grad beyond bound: {floats}")
    check(floats["slope"][1] <= SLOPE_ATOL, f"slope beyond bound: {floats}")
    check(floats["float2uchar_grad"][1] <= 1, f"float2uchar beyond 1: {floats}")
    wall = wall_ms(lambda: jax.block_until_ready(eng.process_all(fd)))
    return {"bit_exact": ",".join(EXACT_KEYS), "float_diffs": floats,
            "wall_ms_per_frame": wall, "peak_bytes": peak_bytes()}


def _variant(cfg: CannyConfig, frame: np.ndarray, want: np.ndarray) -> float:
    eng = CannyEngine(cfg)
    fd = jax.device_put(frame)
    assert_exact(eng.process(fd), want, f"variant {cfg}")
    return wall_ms(lambda: jax.block_until_ready(eng.process(fd)))


def phase_variants(h: int = HD[0], w: int = HD[1],
                   vga: tuple = (480, 640)) -> dict:
    """VGA grayscale, kernel size 3 and 7, L1, opencv parity, and the
    adversarial spiral image at the 100-round cap."""
    res = {}
    gray = make_scene(*vga, seed=2)[..., 0].copy()
    cfg = CannyConfig(height=vga[0], width=vga[1], channels=1)
    res["vga_gray"] = _variant(cfg, gray, oracle_hyster(gray, cfg))
    frame = make_scene(h, w, seed=3)
    for name, kw in (("ks3", {"kernel_size": 3}), ("ks7", {"kernel_size": 7}),
                     ("l1", {"norm": "l1"}), ("opencv", {"parity": "opencv"})):
        cfg = CannyConfig(height=h, width=w, **kw)
        res[name] = _variant(cfg, frame, oracle_hyster(frame, cfg))
    cfg = CannyConfig(height=h, width=w)
    spiral = make_spiral_frame(h, w)
    thresh = oracle.canny_pipeline(spiral)["thresh"]
    want, iters = oracle.hysteresis_capped(
        thresh, max_iters=cfg.max_hysteresis_iters,
        inner_steps=cfg.hysteresis_inner_steps,
        scan_after=cfg.hysteresis_scan_after, return_iters=True,
    )
    res["spiral"] = _variant(cfg, spiral, want)
    truncated = bool((want != oracle.hysteresis(thresh)).any())
    return {"wall_ms_per_frame": res, "spiral_rounds": iters,
            "spiral_cap_truncated": truncated, "peak_bytes": peak_bytes()}


def phase_batch_sweep(h: int = HD[0], w: int = HD[1], b: int = 4) -> dict:
    """A (b, H, W, 3) batch equals b single-frame calls; the K=16 threshold
    sweep equals 16 single-pair calls and the oracle."""
    cfg = CannyConfig(height=h, width=w)
    eng = CannyEngine(cfg)
    host = np.stack([make_scene(h, w, seed=10 + s) for s in range(b)])
    batch = jax.device_put(host)
    outs = np.asarray(eng.process(batch))
    check(outs.shape == (b, h, w), f"batch output shape {outs.shape}")
    for i in range(b):
        single = np.asarray(eng.process(jax.device_put(host[i])))
        assert_exact(outs[i], single, f"batch frame {i} vs single call")
        assert_exact(single, oracle_hyster(host[i], cfg), f"batch frame {i}")
    batch_ms = wall_ms(lambda: jax.block_until_ready(eng.process(batch)), per=b)

    frame = host[0]
    fd = batch[0]
    maps, counts = eng.threshold_sweep(fd, SWEEP_LOWS, SWEEP_HIGHS)
    maps, counts = np.asarray(maps), np.asarray(counts)
    base = oracle.canny_pipeline(frame)
    for k, (lo, hi) in enumerate(zip(SWEEP_LOWS, SWEEP_HIGHS)):
        eng.set_high_threshold(255)
        eng.set_low_threshold(int(lo))
        eng.set_high_threshold(int(hi))
        single = np.asarray(eng.process(fd))
        assert_exact(maps[k], single, f"sweep pair {k} vs single call")
        want = oracle.hysteresis(oracle.double_threshold(base["nms"], lo, hi))
        assert_exact(single, want, f"sweep pair {k}")
        check(int(counts[k]) == int((want == 255).sum()), f"sweep count {k}")
    sweep_ms = wall_ms(lambda: jax.block_until_ready(
        eng.threshold_sweep(fd, SWEEP_LOWS, SWEEP_HIGHS)))
    return {"batch": b, "batch_wall_ms_per_frame": batch_ms,
            "sweep_pairs": len(SWEEP_LOWS), "sweep_wall_ms": sweep_ms,
            "peak_bytes": peak_bytes()}


def phase_mega(sizes: tuple = ((2160, 3840), (4320, 7680))) -> dict:
    """One 4K and one 8K frame through the engine: well-formed edge maps
    ({0, 255}), equal to the oracle."""
    res = {}
    for h, w in sizes:
        cfg = CannyConfig(height=h, width=w)
        eng = CannyEngine(cfg)
        frame = make_scene(h, w, seed=4)
        fd = jax.device_put(frame)
        out = np.asarray(eng.process(fd))
        check(out.shape == (h, w), f"{h}x{w} output shape {out.shape}")
        check(set(np.unique(out).tolist()) <= {0, 255},
              f"{h}x{w} output values outside {{0, 255}}")
        assert_exact(out, oracle_hyster(frame, cfg), f"{h}x{w} frame")
        res[f"{h}x{w}"] = {
            "wall_ms": wall_ms(lambda: jax.block_until_ready(eng.process(fd))),
            "edge_px": int((out == 255).sum()),
        }
    return {"frames": res, "peak_bytes": peak_bytes()}


# -- four-card phase ----------------------------------------------------------


def phase_sharded(n: int = 4, hd: tuple = HD,
                  big: tuple = (4320, 7680)) -> dict:
    """(a) ``n`` distinct cameras on the mesh's batch axis and (b) one big
    frame split over ``n`` row shards (ppermute halos, psum convergence),
    each bit-exact against the single-card CannyEngine on the same frames."""
    res = {}
    cfg = CannyConfig(height=hd[0], width=hd[1])
    devs = jax.devices()[:n]
    cams = np.stack([make_scene(*hd, seed=20 + s) for s in range(n)])
    sh = ShardedCannyEngine(cfg, make_mesh(batch=n, rows=1, devices=devs))
    got = np.asarray(sh.process(cams))
    single = CannyEngine(cfg)
    for i in range(n):
        assert_exact(got[i], np.asarray(single.process(cams[i])),
                     f"batch-sharded camera {i} vs single card")
    cams_d = sh.shard(cams)
    cams_1 = [jax.device_put(c) for c in cams]
    res["cameras_b"] = {
        "sharded_wall_ms_per_frame": wall_ms(
            lambda: jax.block_until_ready(sh.process(cams_d)), per=n),
        "single_card_wall_ms_per_frame": wall_ms(
            lambda: jax.block_until_ready([single.process(c) for c in cams_1]),
            per=n),
    }
    cfg = CannyConfig(height=big[0], width=big[1])
    frame = make_scene(*big, seed=5)[None]
    sh = ShardedCannyEngine(cfg, make_mesh(rows=n, devices=devs))
    got = np.asarray(sh.process(frame))[0]
    single = CannyEngine(cfg)
    fd = jax.device_put(frame[0])
    assert_exact(got, np.asarray(single.process(fd)),
                 f"row-sharded {big[0]}x{big[1]} vs single card")
    frame_d = sh.shard(frame)
    res[f"rows_{big[0]}x{big[1]}"] = {
        "sharded_wall_ms": wall_ms(
            lambda: jax.block_until_ready(sh.process(frame_d))),
        "single_card_wall_ms": wall_ms(
            lambda: jax.block_until_ready(single.process(fd))),
    }
    res["peak_bytes"] = peak_bytes()
    return res


SINGLE_CARD_PHASES = (
    ("stream", phase_stream),
    ("served", phase_served),
    ("all_stages", phase_all_stages),
    ("variants", phase_variants),
    ("batch_sweep", phase_batch_sweep),
    ("mega", phase_mega),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4 runs the sharded multi-card path and nothing else")
    args = p.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees {len(devs)}",
              file=sys.stderr)
        return 2
    cards = card_info()
    for ln in cards:
        print(f"card: {ln}")
    print(f"device_kind: {devs[0].device_kind} x{len(devs)}")
    print(f"jax: {jax.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    print(f"compile_cache: {enable_compile_cache()}")
    label = cards[0]
    phases = ((("sharded", phase_sharded),) if args.cards == 4
              else SINGLE_CARD_PHASES)
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        res["phase_s"] = time.perf_counter() - t0
        print(f"phase {name}: ok {json.dumps(res)} [{label}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sharded-path counts on a virtual 8-device CPU mesh.

Produces the numbers BASELINE/SURVEY ask the sharded design to be judged
by that need no accelerator (they are counts, not times):

* collective inventory from the COMPILED HLO: how many collective-permutes
  run once for the whole feed-forward (asserting the "ONE halo exchange
  covers all FF stages" claim numerically) and how many per hysteresis
  round inside the while body, plus the all-reduce count;
* halo bytes per exchange (from the ppermute operand shapes in the HLO);
* measured convergence ROUNDS (collective rounds, the quantity that
  bounds cross-shard latency) for a natural scene and for an adversarial
  cross-shard snake, on a 2x4 tile mesh.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
          python tools/sharded_virtual_probe.py
(the script forces the CPU platform itself as a fallback).

Prints one JSON line.
"""
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.parallel import build_sharded_pipeline, make_mesh
from cudacam_tpu.parallel.sharded import shard_frame
from cudacam_tpu.stages import CannyStage


def _permute_shapes(txt):
    """Result (byte count, dtype) of every collective-permute instruction
    in an HLO module text (each instruction appears once in its defining
    computation, however many loop rounds execute it). The feed-forward
    halo exchange moves u8 planar strips; the packed hysteresis exchange
    moves u32 bit-plane strips (parallel/packed_halo.py)."""
    shapes = []
    for line in txt.splitlines():
        if "collective-permute(" in line or "collective-permute-start(" in line:
            m = re.search(r"= (u8|u32|s32)\[([\d,]+)\]", line)
            if m:
                el = 4 if m.group(1) in ("u32", "s32") else 1
                shapes.append(
                    el * int(np.prod([int(d) for d in m.group(2).split(",")]))
                )
    return sorted(shapes)


def _hlo_collective_stats(cfg, mesh, frame, lo, hi):
    """(ff_permutes, per_round_permutes, per_round_allreduces,
    halo_bytes_per_round): the THRESH-only program's collectives are the
    feed-forward halo exchange (runs once per frame); the extra
    collectives the full HYSTER program carries live in the convergence
    while-body and run once per ROUND. Diffing the two compiled programs
    attributes them without parsing HLO computation structure."""
    run_ff = build_sharded_pipeline(cfg, mesh, final_stage=CannyStage.THRESH)
    run_full = build_sharded_pipeline(cfg, mesh)
    txt_ff = run_ff.lower(frame, lo, hi).compile().as_text()
    txt_full = run_full.lower(frame, lo, hi).compile().as_text()
    ff_shapes = _permute_shapes(txt_ff)
    full_shapes = _permute_shapes(txt_full)
    hyster_shapes = list(full_shapes)
    for s in ff_shapes:
        hyster_shapes.remove(s)
    # The packed loop issues THREE textually-identical exchange sets
    # (packed_halo.packed_hysteresis_loop): the one-time candidate-plane
    # exchange, the pre-loop FINAL exchange, and the while-BODY FINAL
    # exchange — only the last runs per round. Each set is 2 permutes per
    # active mesh axis.
    assert len(hyster_shapes) % 3 == 0, hyster_shapes
    per_round = len(hyster_shapes) // 3

    def _ar(t):
        return sum(
            1 for line in t.splitlines()
            if "all-reduce(" in line or "all-reduce-start(" in line
        )
    # The loop carries TWO all-reduce instructions (the pre-loop
    # convergence psum and the while-body one); only the body's runs per
    # round.
    return (
        len(ff_shapes),
        per_round,
        (_ar(txt_full) - _ar(txt_ff)) - 1,
        int(sum(hyster_shapes) // 3),
    )


def _rounds_to_converge(cfg, mesh, frame, lo, hi):
    """Smallest global round count whose output equals the converged
    output (probed: the while_loop's count isn't observable)."""
    full = np.asarray(
        build_sharded_pipeline(cfg, mesh)(shard_frame(frame, mesh), lo, hi)
    )
    for k in range(1, cfg.max_hysteresis_iters + 1):
        import dataclasses

        cfg_k = dataclasses.replace(cfg, max_hysteresis_iters=k)
        out = np.asarray(
            build_sharded_pipeline(cfg_k, mesh)(shard_frame(frame, mesh), lo, hi)
        )
        if np.array_equal(out, full):
            return k
    return -1


def main():
    h, w = 1024, 2048  # 512x512 local tiles on the 2x4 mesh
    mesh = make_mesh(batch=1, rows=2, cols=4)
    cfg = CannyConfig(height=h, width=w)
    lo, hi = jnp.int32(10), jnp.int32(40)

    frame = jnp.asarray(make_scene(h, w, seed=0))[None]
    ffp, rp, ra, halo_b = _hlo_collective_stats(
        cfg, mesh, shard_frame(frame, mesh), lo, hi
    )

    # Collective rounds: the benchmark scene vs a snake that crosses every
    # shard boundary (worst natural case: propagation must hop shard to
    # shard; hh = dilate_steps px of cross-shard progress per round).
    scene_rounds = _rounds_to_converge(cfg, mesh, frame, lo, hi)
    # Adversarial cross-shard serpentine: an intensity-80 path (CANDIDATE
    # edges at thresholds 5/90 — the trick test_sharded's ramp line uses)
    # threading every tile top-to-bottom, with ONE strong head segment;
    # promotion must hop shard boundaries round after round.
    g = np.zeros((h, w), np.uint8)
    cols = [w // 16 + i * (w // 4) for i in range(4)]
    top, bot = 8, h - 9
    for i, c in enumerate(cols):
        g[top : bot + 1, c] = 80
        if i + 1 < len(cols):
            r = bot if i % 2 == 0 else top
            g[r, c : cols[i + 1] + 1] = 80
    g[top : top + 24, cols[0]] = 255
    snake = np.stack([g] * 3, axis=-1)
    lo_s, hi_s = jnp.int32(5), jnp.int32(90)
    snake_rounds = _rounds_to_converge(
        cfg, mesh, jnp.asarray(snake)[None], lo_s, hi_s
    )

    print(json.dumps({
        "mesh": "1x2x4 (8 virtual CPU devices)",
        "frame": f"{h}x{w}",
        "local_tile": f"{h // 2}x{w // 4}",
        "ff_collective_permutes_per_frame": ffp,
        "hyster_collective_permutes_per_round": rp,
        "hyster_allreduces_per_round": ra,
        "hyster_halo_bytes_per_round": halo_b,
        # Packed-strip exchange depth (parallel/packed_halo.make_geo):
        # one 32-image-row u32 word-row per vertical side, 64 u32 lanes
        # per horizontal side.
        "hysteresis_halo_px": 32,
        "scene_collective_rounds": scene_rounds,
        "snake_collective_rounds": snake_rounds,
    }))


if __name__ == "__main__":
    main()

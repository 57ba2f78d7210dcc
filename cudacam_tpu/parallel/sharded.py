"""Tile-sharded Canny over a device mesh with halo exchange.

This is the multi-chip generalisation of the reference's intra-GPU tiling
(32x32 shared-memory tiles with 1-2 halo cells, cannyEdgeD.cu:89,140,220,314)
and of its host-coordinated hysteresis relaunch loop (cannyEdgeH.cu:297-338):

- a mega-frame (or batch of camera frames) is partitioned over a
  (batch 'b', rows 'y', cols 'x') mesh;
- each stencil round extends the local tile with halo rows/cols fetched from
  neighbor shards via ``jax.lax.ppermute`` (missing neighbors arrive as
  zeros, which IS the reference's zero-padding semantics,
  cannyEdgeD.cu:91-98);
- the whole mono->threshold chain runs on a once-extended tile, so there is
  ONE halo exchange for all feed-forward stages, not one per stage;
- hysteresis converges on BIT-PACKED planes (ops/bitpack.py's layout) that
  stay the carried state across collective rounds
  (parallel/packed_halo.py): pack happens once per frame, each round
  exchanges packed strips (1 word-row / 64 u32 lanes per side, ~1/8th the
  bytes of u8 halos) and runs an injectable local saturate
  (``bitpack.converge_packed`` by default — the ONE shared
  ``bitpack._make_ops`` round schedule), and a ``psum``'d
  convergence flag replaces the reference's per-iteration device->host
  flag readback (cannyEdgeH.cu:310,322). Unpack happens once, at global
  convergence. Collective rounds are bounded by the cross-shard edge
  diameter, not the pixel diameter.

Correctness note (pollution depth): running the zero-padding single-chip ops
on a tile extended by the *total* halo H yields exact values in the core,
because stage k's output at extended-row r is exact for r >= (sum of stage
halos up to k), which is <= H at the final pre-hysteresis stage.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.ops import bitpack, xla_ops
from cudacam_tpu.parallel.mesh import AXES, BATCH_AXIS, COL_AXIS, ROW_AXIS
from cudacam_tpu.parallel.packed_halo import (
    PackedGeo,
    make_geo,
    packed_hysteresis_loop,
)
from cudacam_tpu.stages import FINAL_EDGE, NO_EDGE, CannyStage

shard_map = jax.shard_map


def _exchange_halo(
    x: jnp.ndarray, lo: int, hi: int, axis: int, axis_name: str, n: int
) -> jnp.ndarray:
    """Extend local tile along ``axis`` with ``lo`` rows/cols before and
    ``hi`` after, fetched from the mesh neighbors on ``axis_name``.
    Boundary shards receive zeros (= the global zero padding of the
    reference's tile fill). ``lo``/``hi`` must not exceed the local tile
    extent (a shard can only export what it owns)."""
    if n == 1 or (lo == 0 and hi == 0):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (lo, hi)
        return jnp.pad(x, pad)
    down = [(i, i + 1) for i in range(n - 1)]  # shard i -> i+1
    up = [(i + 1, i) for i in range(n - 1)]  # shard i+1 -> i

    def take(start: Optional[int], stop: Optional[int]) -> jnp.ndarray:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, stop)
        return x[tuple(idx)]

    parts = []
    if lo:
        # my leading halo = upper neighbor's trailing rows
        parts.append(jax.lax.ppermute(take(-lo, None), axis_name, down))
    parts.append(x)
    if hi:
        parts.append(jax.lax.ppermute(take(None, hi), axis_name, up))
    return jnp.concatenate(parts, axis=axis)


def _trim(x: jnp.ndarray, h: int, axes: tuple[int, ...]) -> jnp.ndarray:
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(h, x.shape[a] - h)
    return x[tuple(idx)]


def xla_packed_saturate(cfg: CannyConfig, geo: PackedGeo) -> Callable:
    """The portable local-saturation operator for the packed round loop:
    ``bitpack.converge_packed`` (both escalating phases of the ONE shared
    round schedule) directly on the carried planes. Pure jnp — identical
    code on CPU virtual meshes, GPUs, and a multi-process cluster."""

    def saturate(f, p):
        nf, _, growing = bitpack.converge_packed(
            f, p, geo.ext_h, geo.ext_w,
            dilate_steps=cfg.hysteresis_inner_steps,
            scan_after=cfg.hysteresis_scan_after,
            max_iters=cfg.max_hysteresis_iters,
        )
        return nf, growing

    return saturate


def build_sharded_pipeline(
    cfg: CannyConfig,
    mesh: Mesh,
    final_stage: CannyStage = CannyStage.HYSTER,
    local_saturate: Optional[Callable] = None,
) -> Callable:
    """Return a jitted fn(frame, low, high) running the pipeline sharded over
    ``mesh``. ``frame`` is (B, H, W[, C]) uint8 with B % mesh('b') == 0,
    H % mesh('y') == 0, W % mesh('x') == 0.

    Hysteresis runs the packed round loop (parallel/packed_halo.py) with
    ``local_saturate`` as the injectable ``(f, p) -> (f, growing)``
    operator (default: :func:`xla_packed_saturate`).
    """
    final_stage = CannyStage(final_stage)
    ny = mesh.shape[ROW_AXIS]
    nx = mesh.shape[COL_AXIS]
    if cfg.height % ny or cfg.width % nx:
        raise ValueError(
            f"frame {cfg.height}x{cfg.width} not divisible by mesh tiles {ny}x{nx}"
        )
    h_loc, w_loc = cfg.height // ny, cfg.width // nx
    halo = cfg.halo  # total feed-forward stencil halo
    if halo > min(h_loc, w_loc):
        raise ValueError(
            f"stencil halo {halo} exceeds local tile {h_loc}x{w_loc}; use fewer shards"
        )

    # --- hysteresis state geometry (packed_halo module docstring) ---------
    geo = make_geo(h_loc, w_loc, ny=ny, nx=nx)
    saturate = (
        local_saturate
        if local_saturate is not None
        else xla_packed_saturate(cfg, geo)
    )

    has_c = cfg.channels == 3
    frame_spec = P(BATCH_AXIS, ROW_AXIS, COL_AXIS, None) if has_c else P(BATCH_AXIS, ROW_AXIS, COL_AXIS)
    out_spec = P(BATCH_AXIS, ROW_AXIS, COL_AXIS)

    def extend2d(x: jnp.ndarray, h: int) -> jnp.ndarray:
        """Symmetric halo extension in rows then cols (the second exchange
        carries the corner blocks)."""
        x = _exchange_halo(x, h, h, 0, ROW_AXIS, ny)
        return _exchange_halo(x, h, h, 1, COL_AXIS, nx)

    def _origin():
        ry = jax.lax.axis_index(ROW_AXIS)
        rx = jax.lax.axis_index(COL_AXIS)
        return ry * h_loc, rx * w_loc

    def _valid_mask(ext_h: int, ext_w: int, h: int) -> jnp.ndarray:
        """Bool mask of extended-tile positions that lie inside the *global*
        image. Positions outside it (only at global-border shards) must read
        as exact zeros to reproduce the single-chip zero-padding semantics
        (the ops' jnp.pad <=> the reference's tile fill, cannyEdgeD.cu:91-98):
        computing a stage on the extended tile leaves nonzero junk there
        otherwise, which the next stencil would consume."""
        row0, col0 = _origin()
        rows = row0 - h + jax.lax.broadcasted_iota(jnp.int32, (ext_h, ext_w), 0)
        cols = col0 - h + jax.lax.broadcasted_iota(jnp.int32, (ext_h, ext_w), 1)
        return (rows >= 0) & (rows < cfg.height) & (cols >= 0) & (cols < cfg.width)

    def local_feed_forward(tile: jnp.ndarray, low, high):
        """mono -> ... -> final_stage on a halo-extended tile, masking each
        intermediate outside the global image; returns the trimmed display
        buffer (or the trimmed thresh map when running to hysteresis)."""
        ext = extend2d(tile, halo)
        valid = _valid_mask(ext.shape[0], ext.shape[1], halo)
        mono = xla_ops.rgb2mono(ext)  # zeros outside stay zero: no mask needed
        if final_stage == CannyStage.MONO:
            return _trim(mono, halo, (0, 1))
        blur = xla_ops.gaussian_blur(mono, cfg.kernel_size)
        blur = jnp.where(valid, blur, jnp.uint8(0))
        if final_stage == CannyStage.GAUSSIAN:
            return _trim(blur, halo, (0, 1))
        sum_x, sum_y = xla_ops.sobel_sums(blur)
        sum_x = jnp.where(valid, sum_x, 0)
        sum_y = jnp.where(valid, sum_y, 0)
        disp_coeff = xla_ops._display_coeff(cfg)
        if final_stage == CannyStage.GRADIENT:
            out = xla_ops.nms_magnitude_u8(sum_x, sum_y, disp_coeff, cfg.norm)
            return _trim(out, halo, (0, 1))
        if final_stage == CannyStage.NMS:
            nms = xla_ops.non_max_suppression(sum_x, sum_y, disp_coeff, cfg.norm)
            nms = jnp.where(valid, nms, jnp.uint8(0))
            return _trim(nms, halo, (0, 1))
        thresh = xla_ops.compute_threshold_map(sum_x, sum_y, low, high, cfg)
        return _trim(thresh, halo, (0, 1))

    def hyster_from_thresh(thresh: jnp.ndarray) -> jnp.ndarray:
        """Portable packed hysteresis from a trimmed core threshold map:
        pack ONCE into the extended grid (zero halos — the first exchange
        populates them), run the packed collective round loop, unpack
        ONCE."""
        t_ext = jnp.pad(
            thresh,
            (
                (geo.e_top, geo.ext_h - geo.e_top - h_loc),
                (geo.e_left, geo.ext_w - geo.e_left - w_loc),
            ),
        )
        f, p = bitpack.pack_pair(t_ext)
        pad = (
            (0, geo.plane_rows - f.shape[0]),
            (0, geo.plane_lanes - geo.ext_w),
        )
        f, p = jnp.pad(f, pad), jnp.pad(p, pad)
        f = packed_hysteresis_loop(
            f, p, jnp.bool_(True), geo, saturate, AXES, ny, nx,
            cfg.max_hysteresis_iters,
        )
        reached = bitpack.unpack_mask(
            f[: geo.hw, geo.e_left : geo.e_left + w_loc],
            geo.e_top + h_loc,
        )[geo.e_top :]
        # removeCandidates (cannyEdgeD.cu:379-395).
        return jnp.where(
            reached, jnp.uint8(FINAL_EDGE), jnp.uint8(NO_EDGE)
        )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(frame_spec, P(), P()),
        out_specs=out_spec,
        check_vma=False,
    )
    def sharded(frame, low, high):
        def per_frame(tile):
            thresh = local_feed_forward(tile, low, high)
            if final_stage == CannyStage.HYSTER:
                return hyster_from_thresh(thresh)
            return thresh

        return jax.vmap(per_frame)(frame)

    @jax.jit
    def run(frame: jnp.ndarray, low: jnp.ndarray, high: jnp.ndarray) -> jnp.ndarray:
        return sharded(frame, low, high)

    return run


def shard_frame(frame, mesh: Mesh):
    """Place a host (B, H, W[, C]) frame batch onto the mesh with the
    pipeline's input sharding (device_put analog of the reference's single
    cudaMemcpy2D upload, cannyEdgeH.cu:136)."""
    spec = (
        P(BATCH_AXIS, ROW_AXIS, COL_AXIS, None)
        if frame.ndim == 4
        else P(BATCH_AXIS, ROW_AXIS, COL_AXIS)
    )
    return jax.device_put(frame, NamedSharding(mesh, spec))

"""XLA (pure jax.numpy) implementation of every Canny stage.

This is the portable compute backend: identical bit-for-bit to the NumPy
oracle (cudacam_tpu/ops/numpy_oracle.py) on every platform, because every
*decision* is integer math — see the oracle's module docstring for the
semantics and the reference citations (src/cvp/cannyEdgeD.cu).

All functions take/return single-frame (H, W[, C]) arrays; batching is done
with jax.vmap at the pipeline level. Stencil borders are zero-padded, exactly
like the reference's shared-memory tile fill (cannyEdgeD.cu:91-98).

XLA fuses the pointwise chains here into a handful of device-memory passes;
hysteresis runs on bit-packed planes (ops/bitpack.py).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cudacam_tpu.config import GAUSSIAN_TAPS, CannyConfig, gaussian_kernel_sum
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.stages import CANDIDATE_EDGE, FINAL_EDGE, NO_EDGE, CannyStage


def rgb2mono(bgr: jnp.ndarray) -> jnp.ndarray:
    """Fixed-point BGR grayscale (reference cannyEdgeD.cu:53-69).

    Slice channels BEFORE the int32 upcast, so the upcasts fuse into the
    weighted-sum loop instead of materializing a 4x-sized int32 copy of the
    whole frame first."""
    if bgr.ndim == 2:
        return bgr.astype(jnp.uint8)
    acc = (
        bgr[..., 0].astype(jnp.int32) * oracle.B_WT
        + bgr[..., 1].astype(jnp.int32) * oracle.G_WT
        + bgr[..., 2].astype(jnp.int32) * oracle.R_WT
    )
    return jnp.minimum(255, acc >> 6).astype(jnp.uint8)


def _shifted(padded: jnp.ndarray, dy: int, dx: int, h: int, w: int, r: int) -> jnp.ndarray:
    """Static slice of a zero-padded plane at offset (dy, dx) from center."""
    return jax.lax.slice(padded, (r + dy, r + dx), (r + dy + h, r + dx + w))


def _conv2d_zero_pad_i32(img_i32: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """Exact int32 2D correlation with zero padding, as an unrolled sum of
    shifted planes (XLA fuses the whole sum into one pass)."""
    kh, kw = taps.shape
    r = kh // 2
    h, w = img_i32.shape
    padded = jnp.pad(img_i32, r)
    acc = jnp.zeros((h, w), jnp.int32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            t = int(taps[dy + r, dx + r])
            if t == 0:
                continue
            term = _shifted(padded, dy, dx, h, w, r)
            acc = acc + (term if t == 1 else (-term if t == -1 else t * term))
    return acc


def gaussian_blur(mono: jnp.ndarray, kernel_size: int = 5) -> jnp.ndarray:
    """Integer Gaussian blur, exact floor division by the tap sum
    (reference cannyEdgeD.cu:72-118; taps cannyEdgeH.cu:372-380)."""
    taps = np.asarray(GAUSSIAN_TAPS[kernel_size], dtype=np.int64)
    s = gaussian_kernel_sum(kernel_size)
    acc = _conv2d_zero_pad_i32(mono.astype(jnp.int32), taps)
    return (acc // s).astype(jnp.uint8)


def sobel_sums(blur: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Raw integer Sobel responses (reference stencils, cannyEdgeD.cu:158-169),
    range [-1020, 1020]."""
    b = blur.astype(jnp.int32)
    sum_x = _conv2d_zero_pad_i32(b, np.asarray(oracle.SOBEL_X))
    sum_y = _conv2d_zero_pad_i32(b, np.asarray(oracle.SOBEL_Y))
    return sum_x, sum_y


def sobel_xy(blur: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Float Sobel planes (reference /8.0, cannyEdgeD.cu:163,169)."""
    sum_x, sum_y = sobel_sums(blur)
    inv8 = jnp.float32(0.125)
    return sum_x.astype(jnp.float32) * inv8, sum_y.astype(jnp.float32) * inv8


def grad_slope(
    sx: jnp.ndarray, sy: jnp.ndarray, grad_coeff: int = 4, norm: str = "l2"
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Float magnitude/direction planes for display (cannyEdgeD.cu:175-198)."""
    if norm == "l2":
        grad = jnp.float32(grad_coeff) * jnp.sqrt(sx * sx + sy * sy)
    else:
        grad = jnp.float32(grad_coeff) * (jnp.abs(sx) + jnp.abs(sy))
    slope = jnp.arctan2(sx, sy)
    return grad.astype(jnp.float32), slope.astype(jnp.float32)


def exact_isqrt_i32(m: jnp.ndarray) -> jnp.ndarray:
    """Exact integer floor-sqrt for int32 values < 2^24 (so the float32 cast
    is exact), with rounding fix-ups in both directions."""
    s = jnp.sqrt(m.astype(jnp.float32)).astype(jnp.int32)
    s = jnp.where(s * s > m, s - 1, s)
    s = jnp.where((s + 1) * (s + 1) <= m, s + 1, s)
    return s


def _comparable_magnitude(sum_x: jnp.ndarray, sum_y: jnp.ndarray, norm: str) -> jnp.ndarray:
    if norm == "l2":
        return sum_x * sum_x + sum_y * sum_y  # <= 2*1020^2, int32-safe
    return jnp.abs(sum_x) + jnp.abs(sum_y)


def nms_magnitude_u8(
    sum_x: jnp.ndarray, sum_y: jnp.ndarray, grad_coeff: int = 4, norm: str = "l2"
) -> jnp.ndarray:
    """Exact uint8 NMS magnitude (see oracle.nms_magnitude_u8)."""
    if norm == "l2":
        m = sum_x * sum_x + sum_y * sum_y
        val = (exact_isqrt_i32(m) * grad_coeff) // 8
    else:
        val = (grad_coeff * (jnp.abs(sum_x) + jnp.abs(sum_y))) // 8
    return jnp.minimum(val, 255).astype(jnp.uint8)


def threshold_magnitude_bound(
    t: jnp.ndarray, grad_coeff: int, norm: str
) -> jnp.ndarray:
    """Smallest comparable magnitude whose display value exceeds threshold
    ``t`` — the exact inverse of the reference's uint8 magnitude chain, so
    the hot path can compare squared magnitudes against a SCALAR instead of
    computing a per-pixel isqrt:

        min(255, (isqrt(m)*coeff) // 8) > t
          <=> t < 255  and  isqrt(m)*coeff >= 8*(t+1)        (floor duality)
          <=> isqrt(m) >= ceil(8*(t+1)/coeff) =: s_min       (ceil duality)
          <=> m >= s_min*s_min                               (isqrt duality)

    (L1: the display value is (coeff*L1)//8, so the bound is s_min itself.)
    ``t`` is a traced int32 scalar; the result is a traced scalar too, so
    threshold changes still never recompile. For t >= 255 nothing can pass
    (the display value is capped at 255): the bound is pushed above the
    domain maximum (2*1020^2 L2 / 2040 L1)."""
    t = t.astype(jnp.int32)
    s_min = (((t + 1) << 3) + grad_coeff - 1) // grad_coeff
    bound = s_min * s_min if norm == "l2" else s_min
    return jnp.where(t >= 255, jnp.int32(1 << 30), bound)


def nms_keep_mask(
    sum_x: jnp.ndarray, sum_y: jnp.ndarray, norm: str = "l2"
) -> jnp.ndarray:
    """The NMS keep decision (both directional neighbors <= center) with Q15
    sector binning and ties kept (reference cannyEdgeD.cu:201-270; see
    oracle for semantics)."""
    g = _comparable_magnitude(sum_x, sum_y, norm)
    h, w = g.shape
    gp = jnp.pad(g, 1)

    def shift(dy: int, dx: int) -> jnp.ndarray:
        return jax.lax.slice(gp, (1 + dy, 1 + dx), (1 + dy + h, 1 + dx + w))

    # Q15 sector binning (oracle._sector_bins).
    v = jnp.abs(sum_x) << 15
    wmag = jnp.abs(sum_y)
    folded_u = jnp.where(sum_x >= 0, sum_y, -sum_y)
    bin0 = v < wmag * oracle.TG22
    bin2 = v >= wmag * oracle.TG67

    # Directional neighbors per sector (cannyEdgeD.cu:245-264).
    q = jnp.where(
        bin0,
        shift(1, 0),
        jnp.where(
            bin2,
            shift(0, 1),
            jnp.where(folded_u > 0, shift(1, -1), shift(-1, -1)),
        ),
    )
    r = jnp.where(
        bin0,
        shift(-1, 0),
        jnp.where(
            bin2,
            shift(0, -1),
            jnp.where(folded_u > 0, shift(-1, 1), shift(1, 1)),
        ),
    )
    return (q <= g) & (r <= g)


def non_max_suppression(
    sum_x: jnp.ndarray, sum_y: jnp.ndarray, grad_coeff: int = 4, norm: str = "l2"
) -> jnp.ndarray:
    """NMS display buffer: keep-masked uint8 magnitude."""
    keep = nms_keep_mask(sum_x, sum_y, norm)
    mag = nms_magnitude_u8(sum_x, sum_y, grad_coeff=grad_coeff, norm=norm)
    return jnp.where(keep, mag, jnp.uint8(0))


def double_threshold_opencv(
    sum_x: jnp.ndarray,
    sum_y: jnp.ndarray,
    keep: jnp.ndarray,
    low: jnp.ndarray,
    high: jnp.ndarray,
    norm: str = "l2",
) -> jnp.ndarray:
    """Double threshold in OpenCV's magnitude domain (``parity='opencv'``):
    compares against raw Sobel magnitudes, so cv2.Canny threshold values
    carry over 1:1. Exact: sqrt(m) > t <=> m > t*t for integer t (see
    oracle.double_threshold_opencv)."""
    # Clamp to the domain cap before squaring: arbitrary traced thresholds
    # must not overflow int32 (2048^2 fits; see CannyConfig.threshold_cap).
    low = jnp.clip(low.astype(jnp.int32), 0, 2048)
    high = jnp.clip(high.astype(jnp.int32), 0, 2048)
    if norm == "l2":
        m = sum_x * sum_x + sum_y * sum_y
        lo_c, hi_c = low * low, high * high
    else:
        m = jnp.abs(sum_x) + jnp.abs(sum_y)
        lo_c, hi_c = low, high
    return jnp.where(
        keep & (m > hi_c),
        jnp.uint8(FINAL_EDGE),
        jnp.where(keep & (m > lo_c), jnp.uint8(CANDIDATE_EDGE), jnp.uint8(NO_EDGE)),
    )


def double_threshold(nms: jnp.ndarray, low: jnp.ndarray, high: jnp.ndarray) -> jnp.ndarray:
    """Strict double threshold (cannyEdgeD.cu:273-293). low/high may be traced
    scalars, so runtime threshold changes never recompile."""
    nms_i = nms.astype(jnp.int32)
    return jnp.where(
        nms_i > high,
        jnp.uint8(FINAL_EDGE),
        jnp.where(nms_i > low, jnp.uint8(CANDIDATE_EDGE), jnp.uint8(NO_EDGE)),
    )


def _dilate8(f: jnp.ndarray) -> jnp.ndarray:
    """8-neighborhood OR with zero padding (bool plane)."""
    h, w = f.shape
    fp = jnp.pad(f, 1)

    def s(dy: int, dx: int) -> jnp.ndarray:
        return jax.lax.slice(fp, (1 + dy, 1 + dx), (1 + dy + h, 1 + dx + w))

    return (
        s(-1, -1) | s(-1, 0) | s(-1, 1) | s(0, -1) | s(0, 1) | s(1, -1) | s(1, 0) | s(1, 1)
    )


def hysteresis(
    thresh: jnp.ndarray,
    max_iters: int = 100,
    inner_steps: int = 16,
    remove_candidates: bool = True,
    return_iters: bool = False,
    scan_after: int = 10,
):
    """On-device edge-tracking hysteresis to the global fixed point.

    Replaces the reference's host relaunch loop (cannyEdgeH.cu:297-338) with
    a single jitted while_loop over the bit-packed state (ops/bitpack.py):
    each round applies ``inner_steps`` fused bit-parallel promote-by-dilation
    steps (candidates 8-adjacent to a FINAL edge become FINAL,
    cannyEdgeD.cu:342-356), escalating to carry-lookahead run scans after
    ``scan_after`` rounds, then checks global convergence on-device — no
    host round-trip per iteration, unlike the reference's per-iteration flag
    readback (cannyEdgeH.cu:310,322). ``max_iters`` is the safety belt
    (reference caps at 100 relaunches, cannyEdgeH.cu:313). Every executor
    calls this same implementation, so outputs are bit-identical across
    them even when the cap truncates (numpy_oracle.hysteresis_capped).
    """
    from cudacam_tpu.ops.bitpack import hysteresis_packed

    return hysteresis_packed(
        thresh,
        max_iters=max_iters,
        remove_candidates=remove_candidates,
        return_iters=return_iters,
        dilate_steps=inner_steps,
        scan_after=scan_after,
    )


def hysteresis_dilate_loop(
    thresh: jnp.ndarray,
    max_iters: int = 100,
    inner_steps: int = 16,
    remove_candidates: bool = True,
    return_iters: bool = False,
):
    """Legacy unpacked dilate-loop hysteresis (the pre-bitpack XLA path).

    Kept as an independently-derived implementation for differential tests.
    Semantics note: its cap
    truncates at max_iters*inner_steps pixel steps, which can differ from
    the packed cap's truncation point — only the converged fixed points are
    guaranteed identical.
    """
    final = thresh == FINAL_EDGE
    cand = thresh == CANDIDATE_EDGE

    def promote(f: jnp.ndarray) -> jnp.ndarray:
        return f | (cand & _dilate8(f))

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    def body(state):
        f, _, it = state
        nf = f
        for _ in range(inner_steps):
            nf = promote(nf)
        changed = jnp.any(nf != f)
        return nf, changed, it + 1

    reached, _, iters = jax.lax.while_loop(
        cond, body, (final, jnp.bool_(True), jnp.int32(0))
    )

    if remove_candidates:
        out = jnp.where(reached, jnp.uint8(FINAL_EDGE), jnp.uint8(NO_EDGE))
    else:
        out = jnp.where(reached, jnp.uint8(FINAL_EDGE), thresh)
    if return_iters:
        return out, iters
    return out


def float2uchar(x: jnp.ndarray) -> jnp.ndarray:
    """Display conversion (cannyEdgeD.cu:35-50)."""
    return jnp.minimum(jnp.abs(x), jnp.float32(255.0)).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Whole-pipeline builders
# ---------------------------------------------------------------------------

def _display_coeff(cfg: CannyConfig) -> int:
    """Magnitude coefficient for display buffers: the reference's grad_coeff
    in 'reference' parity; 8 in 'opencv' parity so the displayed value is the
    raw Sobel magnitude clamp ((s*8)//8 == s)."""
    return cfg.grad_coeff if cfg.parity == "reference" else 8


def compute_threshold_map(
    sum_x: jnp.ndarray,
    sum_y: jnp.ndarray,
    low: jnp.ndarray,
    high: jnp.ndarray,
    cfg: CannyConfig,
) -> jnp.ndarray:
    """NMS + double threshold under the configured parity domain:
    'reference' thresholds the reference's uint8 magnitude
    (grad_coeff*sqrt(m)/8 truncated, cannyEdgeD.cu:195,267); 'opencv'
    thresholds raw Sobel magnitudes so cv2.Canny values carry over 1:1.

    The 'reference' comparison is evaluated WITHOUT per-pixel sqrt by
    mapping each traced threshold to a scalar bound in the comparable
    magnitude domain (threshold_magnitude_bound): exact, and removes the
    isqrt chain from the hot path."""
    keep = nms_keep_mask(sum_x, sum_y, cfg.norm)
    if cfg.parity == "reference":
        g = _comparable_magnitude(sum_x, sum_y, cfg.norm)
        lo_b = threshold_magnitude_bound(low, cfg.grad_coeff, cfg.norm)
        hi_b = threshold_magnitude_bound(high, cfg.grad_coeff, cfg.norm)
        return jnp.where(
            keep & (g >= hi_b),
            jnp.uint8(FINAL_EDGE),
            jnp.where(
                keep & (g >= lo_b),
                jnp.uint8(CANDIDATE_EDGE),
                jnp.uint8(NO_EDGE),
            ),
        )
    return double_threshold_opencv(sum_x, sum_y, keep, low, high, cfg.norm)

def canny_all_stages(
    frame: jnp.ndarray,
    low: jnp.ndarray,
    high: jnp.ndarray,
    cfg: CannyConfig,
) -> Dict[str, jnp.ndarray]:
    """Run all stages, returning every display/inspection buffer. Mirrors the
    reference's keep-every-intermediary design (README.md:22) for stage
    visualisation."""
    mono = rgb2mono(frame)
    blur = gaussian_blur(mono, cfg.kernel_size)
    sum_x, sum_y = sobel_sums(blur)
    inv8 = jnp.float32(0.125)
    sx = sum_x.astype(jnp.float32) * inv8
    sy = sum_y.astype(jnp.float32) * inv8
    grad, slope = grad_slope(sx, sy, cfg.grad_coeff, cfg.norm)
    nms = non_max_suppression(sum_x, sum_y, _display_coeff(cfg), cfg.norm)
    thresh = compute_threshold_map(sum_x, sum_y, low, high, cfg)
    hyster = hysteresis(thresh, cfg.max_hysteresis_iters, cfg.hysteresis_inner_steps,
                       scan_after=cfg.hysteresis_scan_after)
    return {
        "mono": mono,
        "gaussian": blur,
        "sobel_x": sx,
        "sobel_y": sy,
        "grad": grad,
        "slope": slope,
        # Exact-integer GRADIENT display == float2uchar(grad) up to float
        # rounding; see oracle.canny_pipeline.
        "gradient_display": nms_magnitude_u8(sum_x, sum_y, _display_coeff(cfg), cfg.norm),
        "nms": nms,
        "thresh": thresh,
        "hyster": hyster,
    }


#: Display buffer key per stage (reference _sendOutputToOpenGL,
#: cannyEdgeH.cu:173-201; GRADIENT goes through float2uchar at :185).
STAGE_DISPLAY_KEY: Dict[CannyStage, str] = {
    CannyStage.MONO: "mono",
    CannyStage.GAUSSIAN: "gaussian",
    CannyStage.GRADIENT: "gradient_display",
    CannyStage.NMS: "nms",
    CannyStage.THRESH: "thresh",
    CannyStage.HYSTER: "hyster",
}


def threshold_sweep(
    frame: jnp.ndarray,
    lows: jnp.ndarray,
    highs: jnp.ndarray,
    cfg: CannyConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the pipeline once to NMS, then vmap the threshold+hysteresis tail
    over K (low, high) pairs — BASELINE.json config 3's threshold-sweep
    tooling as a single compiled program. The reference would need K full
    kernel-chain relaunches for this; here the feed-forward stages are
    computed once and only the data-dependent tail fans out.

    Returns (maps, edge_counts): (K, H, W) uint8 edge maps and (K,) int32
    FINAL-edge counts.
    """
    mono = rgb2mono(frame)
    blur = gaussian_blur(mono, cfg.kernel_size)
    sum_x, sum_y = sobel_sums(blur)

    def tail(lo, hi):
        th = compute_threshold_map(sum_x, sum_y, lo, hi, cfg)
        return hysteresis(th, cfg.max_hysteresis_iters, cfg.hysteresis_inner_steps,
                          scan_after=cfg.hysteresis_scan_after)

    maps = jax.vmap(tail)(jnp.asarray(lows, jnp.int32), jnp.asarray(highs, jnp.int32))
    counts = (maps == FINAL_EDGE).sum(axis=(1, 2)).astype(jnp.int32)
    return maps, counts


def canny_to_stage(
    frame: jnp.ndarray,
    low: jnp.ndarray,
    high: jnp.ndarray,
    cfg: CannyConfig,
    final_stage: CannyStage,
) -> jnp.ndarray:
    """Cumulative run to ``final_stage``, computing only what that stage
    needs (reference runs stages 0..k, cannyEdgeH.cu:49-120) and returning
    its uint8 display buffer."""
    mono = rgb2mono(frame)
    if final_stage == CannyStage.MONO:
        return mono
    blur = gaussian_blur(mono, cfg.kernel_size)
    if final_stage == CannyStage.GAUSSIAN:
        return blur
    sum_x, sum_y = sobel_sums(blur)
    if final_stage == CannyStage.GRADIENT:
        # Exact-integer equivalent of float2uchar(grad) (cannyEdgeH.cu:185).
        return nms_magnitude_u8(sum_x, sum_y, _display_coeff(cfg), cfg.norm)
    if final_stage == CannyStage.NMS:
        return non_max_suppression(sum_x, sum_y, _display_coeff(cfg), cfg.norm)
    thresh = compute_threshold_map(sum_x, sum_y, low, high, cfg)
    if final_stage == CannyStage.THRESH:
        return thresh
    return hysteresis(thresh, cfg.max_hysteresis_iters, cfg.hysteresis_inner_steps,
                       scan_after=cfg.hysteresis_scan_after)

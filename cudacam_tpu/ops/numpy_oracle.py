"""Pure-NumPy golden oracle for every Canny stage.

This is the framework's *correctness anchor*: a slow, obviously-correct,
bit-deterministic re-derivation of the reference pipeline's behavior
(reference device kernels: src/cvp/cannyEdgeD.cu). The JAX/XLA ops are
tested bit-exactly against this module, on the CPU and on the GPU.

Framework semantics (documented deviations from the CUDA reference — all
chosen to make results *bit-deterministic across hardware*, which the
reference's float paths are not):

* Gaussian blur (reference cannyEdgeD.cu:72-118 accumulates
  ``float(tap/159) * pixel`` and truncates): we accumulate the exact integer
  convolution and take an exact floor division by the tap sum. Differs from
  the reference by at most 1 LSB on float-rounding boundary pixels.
* NMS magnitude (reference cannyEdgeD.cu:267 truncates
  ``4*sqrtf(sx^2+sy^2)``): for the reference configuration
  (grad_coeff=4, /8 Sobel normalisation, L2 norm) the value equals
  ``sqrt(m)/2`` with ``m = sumX^2 + sumY^2`` an exact integer, so we compute
  ``isqrt(m) // 2`` exactly. No float sqrt appears in any *decision*:
  NMS neighbor comparisons are done on exact squared magnitudes
  (``q <= g  <=>  q^2 <= g^2`` for non-negative values).
* NMS direction binning (reference cannyEdgeD.cu:239-264 computes
  ``atan2(sX, sY)`` in degrees and compares against 22.5/67.5/112.5/157.5):
  we bin with two exact comparisons against tan(22.5)/tan(67.5) multiples,
  mathematically identical except for inputs that land exactly on a sector
  boundary, which cannot occur for integer Sobel responses (the boundary
  tangents are irrational) other than axis-aligned gradients, which are
  handled to match the reference.

The float ``grad``/``slope`` planes (display path, cannyEdgeD.cu:175-198)
are still produced for stage visualisation, matching the reference formulas.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from cudacam_tpu.config import GAUSSIAN_TAPS, gaussian_kernel_sum
from cudacam_tpu.stages import CANDIDATE_EDGE, FINAL_EDGE, NO_EDGE

# Grayscale fixed-point weights (reference cannyEdgeD.cu:14-19):
# int(64 * w + 0.5) for w in (0.114, 0.587, 0.299).
B_WT = 7
G_WT = 38
R_WT = 19

# Sector tangents for NMS binning, in Q15 fixed point (same device-friendly
# trick OpenCV's Canny uses): exact int32 comparisons, bit-identical on every
# backend. TG22 = round(tan(22.5 deg) * 2^15), TG67 = round(tan(67.5) * 2^15).
TG22 = int(round(math.tan(math.radians(22.5)) * (1 << 15)))  # 13573
TG67 = int(round(math.tan(math.radians(67.5)) * (1 << 15)))  # 79109


def rgb2mono(bgr: np.ndarray) -> np.ndarray:
    """Fixed-point grayscale (reference cannyEdgeD.cu:53-69).

    Input is BGR byte order (OpenCV), despite the reference's `rgb` naming:
    channel 0 gets the blue weight (cannyEdgeD.cu:67).
    """
    if bgr.ndim == 2:
        return bgr.astype(np.uint8)
    assert bgr.ndim == 3 and bgr.shape[2] == 3, bgr.shape
    px = bgr.astype(np.int32)
    acc = px[..., 0] * B_WT + px[..., 1] * G_WT + px[..., 2] * R_WT
    return np.minimum(255, acc >> 6).astype(np.uint8)


def _conv2d_zero_pad_int(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Exact int32 2D correlation with zero padding outside the image
    (reference pads shared-memory tiles with zeros, cannyEdgeD.cu:91-98)."""
    kh, kw = taps.shape
    rh, rw = kh // 2, kw // 2
    padded = np.pad(img.astype(np.int32), ((rh, rh), (rw, rw)))
    out = np.zeros(img.shape, dtype=np.int64)
    for r in range(kh):
        for c in range(kw):
            out += int(taps[r, c]) * padded[r : r + img.shape[0], c : c + img.shape[1]].astype(np.int64)
    return out.astype(np.int64)


def gaussian_blur(mono: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """Integer Gaussian blur (reference cannyEdgeD.cu:72-118).

    Exact: floor(sum(tap * px) / tap_sum). Output uint8 (the un-normalised
    sum is <= 255 * tap_sum, so the quotient is always <= 255).
    """
    taps = np.asarray(GAUSSIAN_TAPS[kernel_size], dtype=np.int64)
    s = gaussian_kernel_sum(kernel_size)
    acc = _conv2d_zero_pad_int(mono, taps)
    return (acc // s).astype(np.uint8)


# Sobel stencils (reference cannyEdgeD.cu:158-169):
# X = right - left; Y = top - bottom (rows increase downward).
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.int64)
SOBEL_Y = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=np.int64)


def sobel_sums(blur: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Raw integer Sobel responses (before the reference's /8, which is kept
    symbolic so downstream math stays exact). Range [-4*255, 4*255]."""
    sum_x = _conv2d_zero_pad_int(blur, SOBEL_X)
    sum_y = _conv2d_zero_pad_int(blur, SOBEL_Y)
    return sum_x, sum_y


def sobel_xy(blur: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Float Sobel planes as the reference stores them: sum / 8.0
    (cannyEdgeD.cu:163,169). Exact in float32 (|sum| <= 1020)."""
    sum_x, sum_y = sobel_sums(blur)
    return (
        (sum_x.astype(np.float32) / np.float32(8.0)),
        (sum_y.astype(np.float32) / np.float32(8.0)),
    )


def grad_slope(
    sx: np.ndarray, sy: np.ndarray, grad_coeff: int = 4, norm: str = "l2"
) -> Tuple[np.ndarray, np.ndarray]:
    """Float gradient magnitude + direction for display / inspection
    (reference cannyEdgeD.cu:175-198): grad = coeff * sqrt(sx^2 + sy^2),
    slope = atan2(sx, sy) — note the reference's swapped argument order.
    The 'l1' norm is the BASELINE.json config-3 extension."""
    sx = sx.astype(np.float32)
    sy = sy.astype(np.float32)
    if norm == "l2":
        grad = np.float32(grad_coeff) * np.sqrt(sx * sx + sy * sy, dtype=np.float32)
    else:
        grad = np.float32(grad_coeff) * (np.abs(sx) + np.abs(sy))
    slope = np.arctan2(sx, sy).astype(np.float32)
    return grad, slope


def _exact_isqrt(m: np.ndarray) -> np.ndarray:
    """Exact integer floor-sqrt for int64 arrays (vectorised)."""
    s = np.sqrt(m.astype(np.float64)).astype(np.int64)
    # Fix up potential float rounding in both directions.
    s = np.where(s * s > m, s - 1, s)
    s = np.where((s + 1) * (s + 1) <= m, s + 1, s)
    return s


def nms_magnitude_u8(
    sum_x: np.ndarray, sum_y: np.ndarray, grad_coeff: int = 4, norm: str = "l2"
) -> np.ndarray:
    """Exact uint8 NMS output magnitude.

    Reference (cannyEdgeD.cu:267) stores ``min((uchar)gradVal, 255)``, i.e.
    truncation of ``coeff * sqrt((sumX/8)^2 + (sumY/8)^2)``. With coeff=4
    that is floor(sqrt(m)/2) = isqrt(m) // 2, computed exactly here.
    For L1: floor(coeff * (|sumX| + |sumY|) / 8) — exact integer math.
    """
    if norm == "l2":
        m = sum_x * sum_x + sum_y * sum_y
        val = (_exact_isqrt(m) * grad_coeff) // 8
    else:
        val = (grad_coeff * (np.abs(sum_x) + np.abs(sum_y))) // 8
    return np.minimum(val, 255).astype(np.uint8)


def _sector_bins(sum_x: np.ndarray, sum_y: np.ndarray) -> np.ndarray:
    """NMS direction sectors 0..3, matching the reference's binning of
    angle = atan2(sX, sY) * 180/pi folded to [0, 180] (cannyEdgeD.cu:239-264).

    Tan-comparison form (v = |sX|, u = sY folded so the angle lies in the
    upper half plane, w = |sY|), in Q15 integer fixed point:
      sector 0 (N/S neighbors):            (v << 15) <  w * TG22
      sector 2 (E/W neighbors):            (v << 15) >= w * TG67
      sector 1 ((r+1,c-1)/(r-1,c+1)):      else, folded u > 0
      sector 3 ((r-1,c-1)/(r+1,c+1)):      else, folded u < 0
    Equivalent to the reference's float atan2 comparisons everywhere except
    within ~2^-15 of a sector boundary, where the reference's own float path
    is rounding-ambiguous anyway.
    """
    v = np.abs(sum_x).astype(np.int64) << 15
    w = np.abs(sum_y).astype(np.int64)
    u_sign = np.where(sum_x >= 0, np.sign(sum_y), -np.sign(sum_y))
    bin0 = v < w * TG22
    bin2 = v >= w * TG67
    sector = np.full(sum_x.shape, 1, dtype=np.int32)
    sector[u_sign < 0] = 3
    sector[bin2] = 2
    sector[bin0] = 0
    return sector


def non_max_suppression(
    sum_x: np.ndarray, sum_y: np.ndarray, grad_coeff: int = 4, norm: str = "l2"
) -> np.ndarray:
    """NMS (reference cannyEdgeD.cu:201-270), fully exact.

    Keeps a pixel iff both directional neighbors q, r satisfy
    q <= g and r <= g (ties kept, cannyEdgeD.cu:267) — the decision lives in
    nms_keep_mask; this applies the uint8 display magnitude to it.
    """
    keep = nms_keep_mask(sum_x, sum_y, norm)
    mag = nms_magnitude_u8(sum_x, sum_y, grad_coeff=grad_coeff, norm=norm)
    return np.where(keep, mag, np.uint8(0)).astype(np.uint8)


def double_threshold(nms: np.ndarray, low: int, high: int) -> np.ndarray:
    """Strict double threshold (reference cannyEdgeD.cu:273-293):
    > high -> FINAL_EDGE(255); > low -> CANDIDATE_EDGE(128); else 0."""
    out = np.where(
        nms > high,
        np.uint8(FINAL_EDGE),
        np.where(nms > low, np.uint8(CANDIDATE_EDGE), np.uint8(NO_EDGE)),
    )
    return out.astype(np.uint8)


def nms_keep_mask(sum_x: np.ndarray, sum_y: np.ndarray, norm: str = "l2") -> np.ndarray:
    """The NMS keep decision alone (both directional neighbors <= center),
    independent of the magnitude representation."""
    if norm == "l2":
        g = sum_x * sum_x + sum_y * sum_y
    else:
        g = np.abs(sum_x) + np.abs(sum_y)
    h, w = g.shape
    gp = np.pad(g, 1)

    def shift(dy: int, dx: int) -> np.ndarray:
        return gp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    sector = _sector_bins(sum_x, sum_y)
    q = np.choose(sector, [shift(1, 0), shift(1, -1), shift(0, 1), shift(-1, -1)])
    r = np.choose(sector, [shift(-1, 0), shift(-1, 1), shift(0, -1), shift(1, 1)])
    return (q <= g) & (r <= g)


def double_threshold_opencv(
    sum_x: np.ndarray,
    sum_y: np.ndarray,
    keep: np.ndarray,
    low: int,
    high: int,
    norm: str = "l2",
) -> np.ndarray:
    """Double threshold in *OpenCV's* magnitude domain (the framework's
    ``parity='opencv'`` mode): thresholds compare against the raw Sobel
    magnitude sqrt(sumX^2 + sumY^2) (L2) or |sumX|+|sumY| (L1) — exactly the
    quantity ``cv2.Canny(blurred, low, high, L2gradient=...)`` thresholds —
    so cv2 threshold values carry over 1:1. Decisions stay exact integer:
    sqrt(m) > t  <=>  m > t*t for integer t.

    The reference's own domain (``parity='reference'``) instead thresholds
    ``grad_coeff * sqrt(m) / 8`` truncated to uint8 (cannyEdgeD.cu:195,267).
    """
    if norm == "l2":
        m = sum_x * sum_x + sum_y * sum_y
        lo_c, hi_c = int(low) * int(low), int(high) * int(high)
    else:
        m = np.abs(sum_x) + np.abs(sum_y)
        lo_c, hi_c = int(low), int(high)
    out = np.where(
        keep & (m > hi_c),
        np.uint8(FINAL_EDGE),
        np.where(keep & (m > lo_c), np.uint8(CANDIDATE_EDGE), np.uint8(NO_EDGE)),
    )
    return out.astype(np.uint8)


def hysteresis(thresh: np.ndarray, remove_candidates: bool = True) -> np.ndarray:
    """Edge-tracking hysteresis to its global fixed point.

    The reference iterates per-32x32-block promotion to saturation and
    relaunches the kernel from the host until no block changes
    (cannyEdgeD.cu:295-377; cannyEdgeH.cu:297-338). The fixed point of that
    process is exactly: every CANDIDATE 8-connected (transitively, through
    other candidates) to a FINAL edge becomes FINAL. We compute that fixed
    point directly by morphological reconstruction (BFS over the candidate
    mask seeded by final edges). Image border is zero-padded (non-final).
    """
    final = thresh == FINAL_EDGE
    cand = thresh == CANDIDATE_EDGE
    mask = final | cand
    h, w = final.shape
    reached = final.copy()
    # Classic queue-based reconstruction: exact and O(pixels).
    stack = list(zip(*np.nonzero(final)))
    while stack:
        y, x = stack.pop()
        y0, y1 = max(0, y - 1), min(h, y + 2)
        x0, x1 = max(0, x - 1), min(w, x + 2)
        for ny in range(y0, y1):
            for nx in range(x0, x1):
                if mask[ny, nx] and not reached[ny, nx]:
                    reached[ny, nx] = True
                    stack.append((ny, nx))
    if remove_candidates:
        # removeCandidates (cannyEdgeD.cu:379-395): remaining 128 -> 0.
        return np.where(reached, np.uint8(FINAL_EDGE), np.uint8(NO_EDGE))
    # Pre-cleanup view: promoted candidates are FINAL, others remain 128.
    out = np.where(reached, np.uint8(FINAL_EDGE), thresh)
    return out.astype(np.uint8)


def _shift2d(x: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """out[r, c] = x[r - dy, c - dx], zero fill outside the plane."""
    h, w = x.shape
    out = np.zeros_like(x)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    out[max(dy, 0) : h + min(dy, 0), max(dx, 0) : w + min(dx, 0)] = x[
        max(-dy, 0) : h + min(-dy, 0), max(-dx, 0) : w + min(-dx, 0)
    ]
    return out


def _doubling_steps(extent: int) -> list:
    """Powers of two below ``extent``."""
    steps, s = [], 1
    while s < extent:
        steps.append(s)
        s *= 2
    return steps


def hysteresis_capped(
    thresh: np.ndarray,
    max_iters: int = 100,
    inner_steps: int = 16,
    scan_after: int = 10,
    carry_every: int = 8,
    remove_candidates: bool = True,
    return_iters: bool = False,
):
    """Hysteresis under the framework's round cap, on plain boolean planes.

    ``hysteresis`` above gives the fixed point; this gives what the round
    schedule reaches when ``max_iters`` stops it first (the analog of the
    reference's 100-relaunch safety belt, cannyEdgeH.cu:313). It is the
    schedule of ops/bitpack.py written without bit packing, so the capped
    output of every executor can be checked against it:

    * a step promotes candidates 8-adjacent to a FINAL pixel. Intermediate
      steps are "inexact": they ignore vertical neighbours across the
      32-row bands the packed layout stores in one word (rows 31/32,
      63/64, ...). Every ``carry_every``-th step and the round's last step
      are exact;
    * a phase-1 round is ``inner_steps`` steps. After ``scan_after``
      rounds, each round also runs a scan along each of the 8 directions
      (right, left, down, up, down-right, up-left, down-left, up-right)
      that promotes a whole candidate run behind a FINAL pixel;
    * rounds stop when the FINAL count stops growing, or at ``max_iters``
      rounds (at least one round always runs).
    """
    cand = thresh == CANDIDATE_EDGE
    f = thresh == FINAL_EDGE
    h, w = f.shape
    band = np.arange(h)[:, None] % 32
    band_top, band_bot = band == 0, band == 31

    def step(f, exact):
        v = f | _shift2d(f, 0, 1) | _shift2d(f, 0, -1)
        down, up = _shift2d(v, 1, 0), _shift2d(v, -1, 0)
        if not exact:
            down &= ~band_top
            up &= ~band_bot
        return f | (cand & (v | down | up))

    def dilates(f):
        for i in range(1, inner_steps + 1):
            f = step(f, i % carry_every == 0 or i == inner_steps)
        return f

    hs, vs, ds = _doubling_steps(w), _doubling_steps(h), _doubling_steps(min(h, w))
    directions = (
        (0, 1, hs), (0, -1, hs), (1, 0, vs), (-1, 0, vs),
        (1, 1, ds), (-1, -1, ds), (1, -1, ds), (-1, 1, ds),
    )

    def scans(f):
        for dy, dx, steps in directions:
            g, p = f, cand
            for s in steps:
                g = g | (p & _shift2d(g, dy * s, dx * s))
                p = p & _shift2d(p, dy * s, dx * s)
            f = g
        return f

    prev, f = int(f.sum()), dilates(f)
    cur, it = int(f.sum()), 1
    while cur > prev and it < min(scan_after, max_iters):
        f = dilates(f)
        prev, cur, it = cur, int(f.sum()), it + 1
    while cur > prev and it < max_iters:
        f = scans(dilates(f))
        prev, cur, it = cur, int(f.sum()), it + 1

    if remove_candidates:
        out = np.where(f, np.uint8(FINAL_EDGE), np.uint8(NO_EDGE))
    else:
        out = np.where(f, np.uint8(FINAL_EDGE), thresh).astype(np.uint8)
    return (out, it) if return_iters else out


def float2uchar(x: np.ndarray) -> np.ndarray:
    """Display conversion of float planes (reference cannyEdgeD.cu:35-50):
    min(abs(x), 255) truncated to uint8."""
    return np.minimum(np.abs(x), np.float32(255.0)).astype(np.uint8)


def canny_pipeline(
    frame: np.ndarray,
    low: int = 10,
    high: int = 40,
    kernel_size: int = 5,
    grad_coeff: int = 4,
    norm: str = "l2",
    parity: str = "reference",
) -> dict:
    """Run every stage, returning all display buffers keyed by stage name.
    Mirrors the reference's cumulative stage dispatch (cannyEdgeH.cu:49-120)
    and its stage output selection (_sendOutputToOpenGL, cannyEdgeH.cu:154-212).
    ``parity='opencv'`` thresholds raw Sobel magnitudes instead of the
    reference's scaled uint8 domain (see double_threshold_opencv)."""
    disp_coeff = grad_coeff if parity == "reference" else 8
    mono = rgb2mono(frame)
    blur = gaussian_blur(mono, kernel_size)
    sum_x, sum_y = sobel_sums(blur)
    sx, sy = sum_x.astype(np.float32) / np.float32(8.0), sum_y.astype(np.float32) / np.float32(8.0)
    grad, slope = grad_slope(sx, sy, grad_coeff=grad_coeff, norm=norm)
    nms = non_max_suppression(sum_x, sum_y, grad_coeff=disp_coeff, norm=norm)
    if parity == "reference":
        thresh = double_threshold(nms, low, high)
    else:
        keep = nms_keep_mask(sum_x, sum_y, norm)
        thresh = double_threshold_opencv(sum_x, sum_y, keep, low, high, norm)
    hyster = hysteresis(thresh)
    # GRADIENT display: the reference runs float2uchar over the float grad
    # plane (cannyEdgeH.cu:185). min(trunc(coeff*sqrt(m)/8), 255) equals the
    # exact integer NMS magnitude, so we use that for bit-determinism.
    return {
        "mono": mono,
        "gaussian": blur,
        "sobel_x": sx,
        "sobel_y": sy,
        "grad": grad,
        "slope": slope,
        "gradient_display": nms_magnitude_u8(sum_x, sum_y, grad_coeff=disp_coeff, norm=norm),
        "nms": nms,
        "thresh": thresh,
        "hyster": hyster,
    }

"""Parity measurement vs OpenCV's Canny.

The reference claims its output was "successfully compared to OpenCV own
Canny implementation" but ships no comparison code — it was a manual check
(reference README.md:16). This module is that check as a measured tool.

Bit parity with cv2.Canny is not the goal (the reference itself deviates:
fixed-point grayscale weights cannyEdgeD.cu:14-19, 4x-scaled /8 Sobel
magnitudes cannyEdgeD.cu:28,163, swapped atan2 arguments cannyEdgeD.cu:196,
tie-keeping NMS cannyEdgeD.cu:267). The meaningful metric is structural: how
much of each edge map lies within 1 pixel of the other's. BASELINE.md frames
the target as parity "within NMS tie-break tolerance"; >= 0.95 both ways is
healthy on natural scenes.

Threshold mapping: our magnitudes are ``grad_coeff * |sobel| / 8`` of a
*blurred* frame (cannyEdgeD.cu:195); cv2.Canny thresholds raw Sobel
magnitudes of its *input*. To present both with the same edge density we
pre-blur cv2's input with the same 5x5 kernel and scale its thresholds by
8 / grad_coeff = 2.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _structural_scores(ours: np.ndarray, theirs: np.ndarray) -> Dict[str, float]:
    import cv2

    k = np.ones((3, 3), np.uint8)
    ours_b = ours > 0
    theirs_b = theirs > 0
    ours_d = cv2.dilate(ours, k) > 0
    theirs_d = cv2.dilate(theirs, k) > 0
    n_ours = max(1, int(ours_b.sum()))
    n_theirs = max(1, int(theirs_b.sum()))
    return {
        "ours_within_1px_of_cv2": float((ours_b & theirs_d).sum() / n_ours),
        "cv2_within_1px_of_ours": float((theirs_b & ours_d).sum() / n_theirs),
        "edge_count_ratio": float(n_ours / n_theirs),
        "exact_iou": float(
            (ours_b & theirs_b).sum() / max(1, (ours_b | theirs_b).sum())
        ),
    }


_jit_cache: Dict = {}


def _our_canny(frame: np.ndarray, low: int, high: int, parity: str) -> np.ndarray:
    """Jitted full pipeline (one compiled executable per frame spec)."""
    import jax
    import jax.numpy as jnp

    from cudacam_tpu.config import CannyConfig
    from cudacam_tpu.ops import xla_ops
    from cudacam_tpu.stages import CannyStage

    key = (frame.shape, parity)
    fn = _jit_cache.get(key)
    if fn is None:
        h, w = frame.shape[:2]
        cfg = CannyConfig(height=h, width=w,
                          channels=3 if frame.ndim == 3 else 1, parity=parity)
        fn = jax.jit(
            lambda f, lo, hi: xla_ops.canny_to_stage(
                f, lo, hi, cfg, CannyStage.HYSTER
            )
        )
        _jit_cache[key] = fn
    return np.asarray(fn(jnp.asarray(frame), jnp.int32(low), jnp.int32(high)))


def compare_frame(
    frame: np.ndarray,
    low: int = 10,
    high: int = 40,
    grad_coeff: int = 4,
    parity: str = "opencv",
) -> Dict[str, float]:
    """Run both pipelines on one BGR frame and score structural agreement.

    ``parity='opencv'`` (default) runs the framework in its opencv
    threshold domain, so cv2's thresholds are *identical numbers* —
    thresholds passed here are in the reference's uint8 domain and mapped
    by 8/grad_coeff into both. ``parity='reference'`` runs the framework
    in its DEFAULT (reference) domain with the uint8 thresholds as given —
    the production engine configuration — against cv2 at the EXACT
    magnitude bounds those slider values mean: the
    reference-domain decision ``(coeff*isqrt(m2))>>3 > t`` is equivalent
    to ``m2 >= s_min**2`` with ``s_min = ceil(8*(t+1)/coeff)``
    (xla_ops.threshold_magnitude_bound's dualities), and cv2 with
    L2gradient keeps ``m2 > floor(t_cv**2)``, so ``t_cv =
    sqrt(s_min**2 - 0.5)`` makes both pipelines apply the IDENTICAL
    integer threshold — no residual coarsening skew (the naive
    ``t*8/coeff`` mapping under-set cv2's bound by 2 magnitude units,
    which alone cost ~10% cv2-within-1px at (30,90); docs/parity.md).
    """
    import math

    import cv2
    import jax.numpy as jnp

    from cudacam_tpu.ops import numpy_oracle as oracle

    scale = 8.0 / grad_coeff
    cv_low, cv_high = int(low * scale), int(high * scale)
    if parity == "reference":
        ours = _our_canny(frame, low, high, parity="reference")
        # Exact effective bounds of the reference domain (docstring).
        s_lo = (8 * (low + 1) + grad_coeff - 1) // grad_coeff
        s_hi = (8 * (high + 1) + grad_coeff - 1) // grad_coeff
        cv_low = math.sqrt(s_lo * s_lo - 0.5)
        cv_high = math.sqrt(s_hi * s_hi - 0.5)
    else:
        ours = _our_canny(frame, cv_low, cv_high, parity="opencv")
    # cv2 on the same observable: OUR fixed-point gray + OUR integer blur
    # (cv2.Canny does not blur internally), so the comparison isolates
    # NMS/hysteresis differences only.
    blurred = oracle.gaussian_blur(oracle.rgb2mono(frame), 5)
    cv = cv2.Canny(blurred, cv_low, cv_high, L2gradient=True)
    return _structural_scores(ours, cv)


def pan_zoom_frames(
    base: np.ndarray, n_frames: int = 12, height: int = 288, width: int = 512
) -> List[np.ndarray]:
    """A deterministic 'recorded webcam sequence' derived from one still:
    a slow pan across the image with a zoom-in/out cycle (what a camera on
    a scene produces, minus sensor noise — BASELINE asks parity to hold on
    recorded sequences, not single stills). Committing one base PNG plus
    this schedule reproduces the exact sequence everywhere without
    committing every frame."""
    import cv2

    h0, w0 = base.shape[:2]
    frames: List[np.ndarray] = []
    for i in range(n_frames):
        t = i / max(1, n_frames - 1)
        # Zoom 1.0 -> 1.6 -> 1.0; pan left-to-right, top-to-bottom.
        zoom = 1.0 + 0.6 * (1.0 - abs(2.0 * t - 1.0))
        ch, cw = int(h0 / zoom), int(w0 / zoom)
        ch -= ch % 2
        cw -= cw % 2
        y0 = int((h0 - ch) * t)
        x0 = int((w0 - cw) * t)
        crop = base[y0 : y0 + ch, x0 : x0 + cw]
        frames.append(
            cv2.resize(crop, (width, height), interpolation=cv2.INTER_AREA)
        )
    return frames


def parity_report(
    n_frames: int = 5,
    height: int = 540,
    width: int = 960,
    low: int = 10,
    high: int = 40,
    source_spec: Optional[str] = None,
) -> Dict:
    """Aggregate parity over frames from a source (default: synthetic
    scenes + the reference repo's sample photo when present)."""
    frames: List[np.ndarray] = []
    if source_spec:
        from cudacam_tpu.io import open_source

        with open_source(source_spec) as src:
            for i, f in enumerate(src):
                if i >= n_frames:
                    break
                frames.append(f)
    else:
        from cudacam_tpu.io.sources import make_scene

        frames = [make_scene(height, width, seed=s) for s in range(n_frames)]
        try:
            import cv2
            import os

            sample = "/root/reference/ytCanny.jpg"
            if os.path.exists(sample):
                img = cv2.imread(sample)
                if img is not None:
                    frames.append(cv2.resize(img, (width, height)))
        except Exception:
            pass

    if not frames:
        raise ValueError("no frames to compare (check --frames / --source)")
    per_frame = [compare_frame(f, low, high) for f in frames]
    keys = per_frame[0].keys()
    summary = {k: float(np.mean([p[k] for p in per_frame])) for k in keys}
    return {
        "n_frames": len(frames),
        "thresholds": [low, high],
        "summary": summary,
        "per_frame": per_frame,
        "healthy": bool(
            summary["ours_within_1px_of_cv2"] >= 0.90
            and summary["cv2_within_1px_of_ours"] >= 0.90
        ),
    }

"""Parity regression gate on committed natural-image crops.

BASELINE asks for pixel parity vs cv2.Canny "within NMS tie-break
tolerance" on natural images; the round-1 claim (~0.99 within-1px on the
reference photo) was measured but not enforced. These crops are derived
from the reference repo's own sample photo (/root/reference/ytCanny.jpg —
re-encoded 288x512 PNG crops, committed under tests/data/) and the gate
enforces per-direction structural thresholds on every crop, so a parity
regression in NMS/threshold/hysteresis fails CI rather than being
remembered wrongly. Measured at gate-creation (low=10, high=40):
ours-within-1px >= 0.977, cv2-within-1px >= 0.9996, exact IoU >= 0.956.
"""
import glob
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cudacam_tpu.parity import compare_frame

_DATA = os.path.join(os.path.dirname(__file__), "data")
_CROPS = sorted(glob.glob(os.path.join(_DATA, "ytcrop_*.png")))

# Gate thresholds: a little under the measured floor so jpeg/opencv version
# drift doesn't flake, but tight enough that any semantic regression
# (tie-breaks, sector bins, hysteresis connectivity) trips them.
MIN_OURS_NEAR_CV = 0.95
MIN_CV_NEAR_OURS = 0.98
MIN_EXACT_IOU = 0.90
EDGE_RATIO_RANGE = (0.90, 1.15)


@pytest.mark.parametrize("path", _CROPS, ids=[os.path.basename(p) for p in _CROPS])
def test_crop_parity_gate(path):
    frame = cv2.imread(path)
    assert frame is not None and frame.shape == (288, 512, 3)
    s = compare_frame(frame, low=10, high=40)
    assert s["ours_within_1px_of_cv2"] >= MIN_OURS_NEAR_CV, s
    assert s["cv2_within_1px_of_ours"] >= MIN_CV_NEAR_OURS, s
    assert s["exact_iou"] >= MIN_EXACT_IOU, s
    lo, hi = EDGE_RATIO_RANGE
    assert lo <= s["edge_count_ratio"] <= hi, s


def test_gate_has_crops():
    assert len(_CROPS) == 4, _CROPS


def test_alternate_thresholds_hold():
    frame = cv2.imread(_CROPS[0])
    s = compare_frame(frame, low=30, high=90)
    assert s["ours_within_1px_of_cv2"] >= 0.93, s
    assert s["cv2_within_1px_of_ours"] >= 0.97, s


# --- sequence gate ------------------------------------
# BASELINE asks parity "on recorded webcam sequences": a deterministic
# pan/zoom sequence derived from the committed base still (the reference
# repo's own sample photo, re-encoded) x a grid of threshold pairs, every
# (frame, pair) enforced per-direction (fast enough for the default
# suite: ~6 s for all 36 comparisons).

_BASE = os.path.join(_DATA, "ytbase.png")
_PAIR_GRID = [(10, 40), (20, 60), (30, 90)]
# Floors per (pair, parity domain), a little under the worst frame
# measured at gate creation.
# 'opencv' domain (thresholds carry 1:1 to cv2.Canny): (10,40):
# 0.979/0.999/0.962; (20,60): 0.977/1.000/0.959; (30,90):
# 0.866/0.993/0.831 (high thresholds on the deepest-zoom blurry crops
# keep very few edges, so percentage agreement gets grainy there).
# 'reference' domain (the production engine default): since r5's EXACT
# slider-to-magnitude-bound mapping in parity.compare_frame (the
# (coeff*sqrt(m))>>3 duality — no residual coarsening skew), the
# reference domain measures WITHIN NOISE OF the opencv domain: (10,40):
# 0.979/0.999/0.962; (20,60): 0.976/1.000/0.958; (30,90):
# 0.859/0.995/0.826 (was 0.889/0.891/0.770 under the naive t*8/coeff
# mapping). The remaining (30,90) gap is one-sided (ours is a structural
# superset; per-cause decomposition in docs/parity.md).
_SEQ_MIN = {
    ("opencv", (10, 40)): (0.95, 0.98, 0.92),
    ("opencv", (20, 60)): (0.95, 0.97, 0.91),
    ("opencv", (30, 90)): (0.84, 0.97, 0.80),
    ("reference", (10, 40)): (0.95, 0.98, 0.92),
    ("reference", (20, 60)): (0.95, 0.97, 0.91),
    ("reference", (30, 90)): (0.84, 0.97, 0.80),
}


@pytest.mark.parametrize("parity", ["opencv", "reference"])
@pytest.mark.parametrize("pair", _PAIR_GRID, ids=lambda p: f"lo{p[0]}hi{p[1]}")
def test_sequence_parity_gate(pair, parity):
    from cudacam_tpu.parity import pan_zoom_frames

    base = cv2.imread(_BASE)
    assert base is not None and base.shape == (576, 1024, 3)
    frames = pan_zoom_frames(base, n_frames=12)
    lo, hi = pair
    worst = None
    for i, f in enumerate(frames):
        s = compare_frame(f, low=lo, high=hi, parity=parity)
        key = (s["ours_within_1px_of_cv2"], s["cv2_within_1px_of_ours"],
               s["exact_iou"])
        if worst is None or key < worst[0]:
            worst = (key, i, s)
    (ours_near, cv_near, iou), idx, s = worst
    min_ours, min_cv, min_iou = _SEQ_MIN[(parity, pair)]
    assert ours_near >= min_ours, (idx, s)
    assert cv_near >= min_cv, (idx, s)
    assert iou >= min_iou, (idx, s)

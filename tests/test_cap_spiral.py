"""The hysteresis round cap through the engine: the adversarial spiral
image, truncated at the cap, against numpy_oracle.hysteresis_capped."""
import numpy as np
import pytest

from cudacam_tpu import CannyConfig
from cudacam_tpu.engine import CannyEngine
from cudacam_tpu.io.sources import make_spiral_frame
from cudacam_tpu.ops import numpy_oracle as oracle


@pytest.mark.parametrize(
    "inner_steps,scan_after,max_iters",
    [(16, 64, 100), (16, 10, 30), (4, 2, 5), (1, 1, 3), (3, 7, 20),
     (8, 3, 50), (2, 4, 12), (32, 1, 6)],
)
def test_spiral_at_the_cap_matches_oracle(inner_steps, scan_after, max_iters):
    """The adversarial spiral image through the engine, where the round cap
    stops hysteresis short of the fixed point: the truncated edge map must
    equal numpy_oracle.hysteresis_capped under the same schedule."""
    h, w = 96, 128
    cfg = CannyConfig(height=h, width=w, hysteresis_inner_steps=inner_steps,
                      hysteresis_scan_after=scan_after,
                      max_hysteresis_iters=max_iters)
    frame = make_spiral_frame(h, w)
    thresh = oracle.canny_pipeline(frame)["thresh"]
    want, rounds = oracle.hysteresis_capped(
        thresh, max_iters=max_iters, inner_steps=inner_steps,
        scan_after=scan_after, return_iters=True)
    got = np.asarray(CannyEngine(cfg).process(frame))
    np.testing.assert_array_equal(got, want)
    full = oracle.hysteresis(thresh)
    if rounds < max_iters:  # converged before the cap: the fixed point
        np.testing.assert_array_equal(got, full)
    else:  # truncated: a monotone under-approximation of it
        assert not ((got == 255) & (full != 255)).any()


def test_spiral_cases_include_truncation():
    """At least one spiral case above really stops at the cap."""
    thresh = oracle.canny_pipeline(make_spiral_frame(96, 128))["thresh"]
    capped = oracle.hysteresis_capped(
        thresh, max_iters=5, inner_steps=4, scan_after=2)
    assert (capped == 255).sum() < (oracle.hysteresis(thresh) == 255).sum()

"""The engine's XLA path against the NumPy oracle over frame shapes — the
CPU side of what chip_smoke.py checks on the GPU at full size."""
import pytest

from cudacam_tpu import CannyConfig

from conftest import assert_all_stages_match_oracle, make_test_frame


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h", [8, 37, 64])
@pytest.mark.parametrize("w", [64, 211, 640, 1920])
def test_geometry_matches_oracle(w, h, channels):
    """Odd, tiny and production widths; heights below, across and at the
    32-row packing word; mono and BGR input."""
    frame = make_test_frame(h, w, channels, seed=h * w)
    assert_all_stages_match_oracle(CannyConfig(height=h, width=w, channels=channels), frame)

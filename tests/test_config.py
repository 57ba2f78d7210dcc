"""CannyConfig validation + derived defaults."""
import dataclasses

import numpy as np
import pytest

from cudacam_tpu import CannyConfig
from cudacam_tpu.config import GAUSSIAN_TAPS


class TestValidation:
    def test_rejects_bad_kernel_size(self):
        with pytest.raises(ValueError, match="kernel_size"):
            CannyConfig(height=10, width=10, kernel_size=4)

    def test_rejects_bad_norm(self):
        with pytest.raises(ValueError, match="norm"):
            CannyConfig(height=10, width=10, norm="linf")

    def test_rejects_bad_grad_coeff(self):
        # (isqrt(m)*coeff)//8 == trunc(coeff*sqrt(m)/8) only when coeff
        # divides 8 (cannyEdgeD.cu:28 uses 4).
        with pytest.raises(ValueError, match="grad_coeff"):
            CannyConfig(height=10, width=10, grad_coeff=3)

    def test_rejects_inverted_thresholds(self):
        with pytest.raises(ValueError, match="low_threshold"):
            CannyConfig(height=10, width=10, low_threshold=50, high_threshold=10)

    def test_threshold_cap_by_parity(self):
        assert CannyConfig(height=10, width=10).threshold_cap == 255
        assert CannyConfig(height=10, width=10, parity="opencv").threshold_cap == 2048

    def test_rejects_zero_inner_steps(self):
        with pytest.raises(ValueError, match="inner_steps"):
            CannyConfig(height=10, width=10, hysteresis_inner_steps=0)

    @pytest.mark.parametrize("field", ["backend", "interpret", "continuation"])
    def test_no_kernel_selection_options(self, field):
        # One implementation runs everywhere: no option picks another.
        assert field not in {f.name for f in dataclasses.fields(CannyConfig)}
        with pytest.raises(TypeError):
            CannyConfig(height=10, width=10, **{field: "xla"})


class TestTapSymmetry:
    """The Gaussian taps are symmetric in both axes, so the correlation the
    stencils compute equals the convolution the reference specifies."""

    @pytest.mark.parametrize("ksize", sorted(GAUSSIAN_TAPS))
    def test_taps_symmetric(self, ksize):
        T = np.asarray(GAUSSIAN_TAPS[ksize])
        assert (T == T[::-1]).all()
        assert (T == T[:, ::-1]).all()


class TestDerivedInnerSteps:
    """hysteresis_inner_steps defaults to 16, except 32 in the 4K band.
    The defaults fix the round schedule (and so cap-truncated outputs);
    they have not been re-tuned on the H100."""

    @pytest.mark.parametrize(
        "h,w,want",
        [(480, 640, 16), (1080, 1920, 16), (2160, 3840, 32), (4320, 7680, 16)],
    )
    def test_scales_with_diameter(self, h, w, want):
        assert CannyConfig(height=h, width=w).hysteresis_inner_steps == want

    def test_explicit_value_respected(self):
        cfg = CannyConfig(height=2160, width=3840, hysteresis_inner_steps=8)
        assert cfg.hysteresis_inner_steps == 8

    def test_replace_keeps_resolved_value(self):
        cfg = CannyConfig(height=1080, width=1920)
        assert dataclasses.replace(cfg, low_threshold=5).hysteresis_inner_steps == 16

    def test_with_thresholds_keeps_resolved_value(self):
        cfg = CannyConfig(height=2160, width=3840)
        assert cfg.with_thresholds(5, 50).hysteresis_inner_steps == 32


class TestDerivedScanAfter:
    """hysteresis_scan_after defaults to 64 (<=1080p) / 32 (mega-frames):
    ~2x the deepest phase-1 convergence seen on the synthetic scenes."""

    @pytest.mark.parametrize(
        "h,w,want",
        [(480, 640, 64), (1080, 1920, 64), (2160, 3840, 32), (4320, 7680, 32)],
    )
    def test_derived_default(self, h, w, want):
        assert CannyConfig(height=h, width=w).hysteresis_scan_after == want

    def test_explicit_value_respected(self):
        cfg = CannyConfig(height=1080, width=1920, hysteresis_scan_after=12)
        assert cfg.hysteresis_scan_after == 12

    def test_escalation_valve_reachable(self):
        # The derived default must keep phase 2 reachable (< the cap).
        cfg = CannyConfig(height=1080, width=1920)
        assert cfg.hysteresis_scan_after < cfg.max_hysteresis_iters

    def test_rejects_zero(self):
        with pytest.raises(ValueError, match="scan_after"):
            CannyConfig(height=10, width=10, hysteresis_scan_after=0)

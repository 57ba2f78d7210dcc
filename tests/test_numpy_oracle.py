"""Golden tests for the NumPy oracle on hand-built micro-images.

These pin down the framework's stage semantics (extracted from the reference
device kernels, src/cvp/cannyEdgeD.cu) on inputs small enough to verify by
hand. Everything else in the test suite diffs against this oracle.
"""
import numpy as np
import pytest

from cudacam_tpu.config import GAUSSIAN_TAPS, gaussian_kernel_sum
from cudacam_tpu.ops import numpy_oracle as oracle


class TestMono:
    def test_weights(self):
        # int(64*w + 0.5) for the reference weights (cannyEdgeD.cu:14-19).
        assert oracle.B_WT == 7 and oracle.G_WT == 38 and oracle.R_WT == 19
        assert oracle.B_WT + oracle.G_WT + oracle.R_WT == 64

    def test_bgr_order(self):
        # Channel 0 carries the *blue* weight (cannyEdgeD.cu:67).
        blue = np.zeros((1, 1, 3), np.uint8)
        blue[..., 0] = 255
        red = np.zeros((1, 1, 3), np.uint8)
        red[..., 2] = 255
        assert oracle.rgb2mono(blue)[0, 0] == (255 * 7) >> 6  # 27
        assert oracle.rgb2mono(red)[0, 0] == (255 * 19) >> 6  # 75

    def test_white_saturates(self):
        white = np.full((2, 2, 3), 255, np.uint8)
        assert (oracle.rgb2mono(white) == 255).all()  # (255*64)>>6 == 255

    def test_known_pixel(self):
        px = np.array([[[10, 20, 30]]], np.uint8)  # B,G,R
        expected = (10 * 7 + 20 * 38 + 30 * 19) >> 6
        assert oracle.rgb2mono(px)[0, 0] == expected

    def test_mono_passthrough(self):
        m = np.arange(12, dtype=np.uint8).reshape(3, 4)
        assert (oracle.rgb2mono(m) == m).all()


class TestGaussian:
    def test_impulse_gives_taps(self):
        # Centered impulse of 159 -> floor(tap * 159 / 159) = the taps.
        img = np.zeros((7, 7), np.uint8)
        img[3, 3] = 159
        out = oracle.gaussian_blur(img, 5)
        taps = np.asarray(GAUSSIAN_TAPS[5])
        assert (out[1:6, 1:6] == taps).all()
        assert out[0].sum() == 0 and out[6].sum() == 0

    def test_constant_field_truncation(self):
        # Uniform 100: sum = 100*159, /159 = 100 exactly in the interior.
        img = np.full((9, 9), 100, np.uint8)
        out = oracle.gaussian_blur(img, 5)
        assert (out[2:-2, 2:-2] == 100).all()
        # Borders: zero padding lowers the sum (e.g. corner pixel).
        corner_taps = sum(
            GAUSSIAN_TAPS[5][r][c] for r in range(2, 5) for c in range(2, 5)
        )
        assert out[0, 0] == (100 * corner_taps) // 159

    def test_exact_floor_division(self):
        # Value chosen so float arithmetic would be off-by-one-prone:
        # a uniform field of 1 -> interior sum 159 -> exactly 1.
        img = np.ones((9, 9), np.uint8)
        out = oracle.gaussian_blur(img, 5)
        assert (out[2:-2, 2:-2] == 1).all()

    @pytest.mark.parametrize("ks", [3, 7])
    def test_other_kernel_sizes(self, ks):
        img = np.full((11, 11), 200, np.uint8)
        out = oracle.gaussian_blur(img, ks)
        r = ks // 2
        assert (out[r:-r, r:-r] == 200).all()
        assert gaussian_kernel_sum(ks) in (16, 4096)


class TestSobel:
    def test_horizontal_ramp(self):
        # Columns 0,10,20,...: d/dx = 10 per px -> sumX = 8*10 = 80, /8 = 10.
        img = (np.arange(8)[None, :] * np.ones((6, 1))).astype(np.uint8) * 10
        sx, sy = oracle.sobel_xy(img)
        assert (sx[1:-1, 1:-1] == 10.0).all()
        assert (sy[1:-1, 1:-1] == 0.0).all()

    def test_vertical_ramp_sign(self):
        # Rows increase downward; Y = top - bottom => negative for increasing rows.
        img = (np.arange(6)[:, None] * np.ones((1, 8))).astype(np.uint8) * 10
        sx, sy = oracle.sobel_xy(img)
        assert (sy[1:-1, 1:-1] == -10.0).all()
        assert (sx[1:-1, 1:-1] == 0.0).all()

    def test_range(self):
        img = np.zeros((4, 4), np.uint8)
        img[:, 2:] = 255
        sum_x, sum_y = oracle.sobel_sums(img)
        assert sum_x.max() <= 4 * 255 and sum_x.min() >= -4 * 255


class TestGradSlope:
    def test_grad_formula(self):
        sx = np.array([[3.0]], np.float32)
        sy = np.array([[4.0]], np.float32)
        grad, slope = oracle.grad_slope(sx, sy, grad_coeff=4, norm="l2")
        assert grad[0, 0] == 20.0  # 4 * 5
        # Reference's swapped atan2(sX, sY) (cannyEdgeD.cu:196).
        assert slope[0, 0] == pytest.approx(np.arctan2(3.0, 4.0))

    def test_l1_norm(self):
        sx = np.array([[3.0]], np.float32)
        sy = np.array([[-4.0]], np.float32)
        grad, _ = oracle.grad_slope(sx, sy, grad_coeff=4, norm="l1")
        assert grad[0, 0] == 28.0  # 4 * (3+4)


class TestIsqrt:
    def test_exhaustive_small(self):
        m = np.arange(0, 100000, dtype=np.int64)
        s = oracle._exact_isqrt(m)
        assert (s * s <= m).all() and ((s + 1) * (s + 1) > m).all()

    def test_max_range(self):
        # Max possible magnitude-squared: 2 * 1020^2.
        m = np.array([2 * 1020 * 1020, 2 * 1020 * 1020 - 1], dtype=np.int64)
        s = oracle._exact_isqrt(m)
        assert (s * s <= m).all() and ((s + 1) * (s + 1) > m).all()


class TestNMS:
    def test_sector_axis_aligned(self):
        # Pure horizontal gradient (sum_x != 0, sum_y == 0): angle 90 -> sector 2.
        sx = np.array([[100]], np.int64)
        sy = np.array([[0]], np.int64)
        assert oracle._sector_bins(sx, sy)[0, 0] == 2
        # Pure vertical gradient: angle 0/180 -> sector 0.
        assert oracle._sector_bins(sy, sx)[0, 0] == 0

    def test_sector_diagonals(self):
        # 45 deg: sx=sy>0 -> folded u > 0 -> sector 1.
        s = np.array([[100]], np.int64)
        assert oracle._sector_bins(s, s)[0, 0] == 1
        # 135 deg: sx>0, sy<0 -> folded u < 0 -> sector 3.
        assert oracle._sector_bins(s, -s)[0, 0] == 3
        # Folding: (-sx, -sy) maps to the same sector.
        assert oracle._sector_bins(-s, -s)[0, 0] == 1
        assert oracle._sector_bins(-s, s)[0, 0] == 3

    def test_vertical_edge_kept(self):
        # A sharp vertical edge: gradient along x, sector 2 (E/W neighbors).
        # The two columns adjacent to the edge have equal magnitude -> ties kept
        # on both (q <= g && r <= g with equality), reference keeps them.
        img = np.zeros((8, 8), np.uint8)
        img[:, 4:] = 200
        sum_x, sum_y = oracle.sobel_sums(img)
        nms = oracle.non_max_suppression(sum_x, sum_y)
        # Row 3 (interior): edge response peaks at columns 3 and 4 equally.
        assert nms[3, 3] > 0 and nms[3, 4] > 0
        assert nms[3, 1] == 0 and nms[3, 6] == 0

    def test_magnitude_value(self):
        # sum_x = 6, sum_y = 8 -> grad = 4*sqrt((6/8)^2+(8/8)^2) = sqrt(100)/2 = 5.
        assert oracle.nms_magnitude_u8(np.array([[6]]), np.array([[8]]))[0, 0] == 5

    def test_magnitude_saturates(self):
        v = oracle.nms_magnitude_u8(np.array([[1020]]), np.array([[1020]]))
        assert v[0, 0] == 255  # isqrt(2*1020^2)//2 = 721 -> clamped

    def test_nonmax_suppressed(self):
        # Single bright row -> horizontal line; vertical gradient; peaks at the
        # line, suppressed away from it.
        img = np.zeros((9, 9), np.uint8)
        img[4, :] = 200
        sum_x, sum_y = oracle.sobel_sums(img)
        nms = oracle.non_max_suppression(sum_x, sum_y)
        assert (nms[4, 2:-2] == 0).all()  # on the ridge center grad is 0
        assert (nms[3, 2:-2] > 0).all() and (nms[5, 2:-2] > 0).all()


class TestThreshold:
    def test_strict_inequalities(self):
        nms = np.array([[10, 11, 40, 41, 0]], np.uint8)
        out = oracle.double_threshold(nms, 10, 40)
        assert list(out[0]) == [0, 128, 128, 255, 0]


class TestHysteresis:
    def test_chain_promotion(self):
        # A candidate chain connected to one final edge: all promoted.
        t = np.zeros((5, 9), np.uint8)
        t[2, 1] = 255
        t[2, 2:7] = 128
        out = oracle.hysteresis(t)
        assert (out[2, 1:7] == 255).all()
        assert out.sum() == 255 * 6

    def test_isolated_candidates_removed(self):
        t = np.zeros((5, 5), np.uint8)
        t[1, 1] = 128
        t[3, 3] = 128
        out = oracle.hysteresis(t)
        assert out.sum() == 0

    def test_diagonal_connectivity(self):
        # 8-connectivity: diagonal neighbors propagate (cannyEdgeD.cu:342-350).
        t = np.zeros((6, 6), np.uint8)
        t[0, 0] = 255
        for i in range(1, 5):
            t[i, i] = 128
        out = oracle.hysteresis(t)
        assert all(out[i, i] == 255 for i in range(5))

    def test_gap_blocks_propagation(self):
        t = np.zeros((3, 7), np.uint8)
        t[1, 0] = 255
        t[1, 1] = 128
        # gap at column 2
        t[1, 3] = 128
        out = oracle.hysteresis(t)
        assert out[1, 1] == 255 and out[1, 3] == 0

    def test_keep_candidates_view(self):
        t = np.zeros((3, 5), np.uint8)
        t[1, 0] = 255
        t[1, 1] = 128
        t[1, 3] = 128
        out = oracle.hysteresis(t, remove_candidates=False)
        assert out[1, 1] == 255 and out[1, 3] == 128


class TestHysteresisCapped:
    """The round-capped schedule (hysteresis_capped): with room to
    converge it reaches the same fixed point as the BFS above."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_uncapped_equals_fixed_point(self, seed):
        rng = np.random.default_rng(seed)
        t = rng.choice([0, 128, 255], size=(70, 45),
                       p=[0.5, 0.45, 0.05]).astype(np.uint8)
        got, rounds = oracle.hysteresis_capped(
            t, max_iters=10_000, inner_steps=3, scan_after=4,
            return_iters=True)
        np.testing.assert_array_equal(got, oracle.hysteresis(t))
        assert rounds < 10_000

    def test_band_boundary_stalls_inexact_steps(self):
        """Intermediate steps do not cross the 32-row band boundary: with
        one round of 2 steps (only the last exact), a seed at row 30
        reaches row 31 and then row 32, but not row 33."""
        t = np.zeros((40, 3), np.uint8)
        t[25:40, 1] = 128
        t[30, 1] = 255
        got = oracle.hysteresis_capped(t, max_iters=1, inner_steps=2,
                                       carry_every=8)
        assert got[31, 1] == 255 and got[32, 1] == 255
        assert got[33, 1] == 0 and got[28, 1] == 255

    def test_at_least_one_round_runs(self):
        t = np.zeros((3, 8), np.uint8)
        t[1, 0] = 255
        t[1, 1:8] = 128
        got, rounds = oracle.hysteresis_capped(
            t, max_iters=0, inner_steps=2, return_iters=True)
        assert rounds == 1
        assert list(got[1]) == [255, 255, 255, 0, 0, 0, 0, 0]

    def test_keep_candidates_view(self):
        t = np.zeros((3, 6), np.uint8)
        t[1, 0] = 255
        t[1, 1:6] = 128
        got = oracle.hysteresis_capped(t, max_iters=1, inner_steps=1,
                                       remove_candidates=False)
        assert list(got[1]) == [255, 255, 128, 128, 128, 128]


class TestFloat2Uchar:
    def test_abs_clamp_truncate(self):
        x = np.array([[-3.7, 300.0, 12.9, 255.0]], np.float32)
        out = oracle.float2uchar(x)
        assert list(out[0]) == [3, 255, 12, 255]


class TestFullPipeline:
    def test_runs_and_is_binary(self, bgr_frame):
        res = oracle.canny_pipeline(bgr_frame)
        assert res["hyster"].dtype == np.uint8
        assert set(np.unique(res["hyster"])) <= {0, 255}
        assert set(np.unique(res["thresh"])) <= {0, 128, 255}

    def test_finds_edges_on_synthetic(self):
        img = np.zeros((32, 32, 3), np.uint8)
        img[:, 16:] = 220
        res = oracle.canny_pipeline(img)
        assert (res["hyster"] > 0).any()

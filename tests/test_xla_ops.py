"""Bit-exact equivalence of the XLA implementation vs the NumPy oracle."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cudacam_tpu.config import CannyConfig
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.stages import CannyStage

from conftest import make_bgr_frame, make_noise_frame


def _cfg(h, w, **kw):
    return CannyConfig(height=h, width=w, **kw)


class TestStageEquivalence:
    def test_mono(self, bgr_frame):
        got = np.asarray(xla_ops.rgb2mono(jnp.asarray(bgr_frame)))
        np.testing.assert_array_equal(got, oracle.rgb2mono(bgr_frame))

    @pytest.mark.parametrize("ks", [3, 5, 7])
    def test_gaussian(self, bgr_frame, ks):
        mono = oracle.rgb2mono(bgr_frame)
        got = np.asarray(xla_ops.gaussian_blur(jnp.asarray(mono), ks))
        np.testing.assert_array_equal(got, oracle.gaussian_blur(mono, ks))

    def test_sobel(self, bgr_frame):
        blur = oracle.gaussian_blur(oracle.rgb2mono(bgr_frame))
        gx, gy = xla_ops.sobel_sums(jnp.asarray(blur))
        ex, ey = oracle.sobel_sums(blur)
        np.testing.assert_array_equal(np.asarray(gx), ex)
        np.testing.assert_array_equal(np.asarray(gy), ey)

    @pytest.mark.parametrize("norm", ["l1", "l2"])
    def test_nms(self, noise_frame, norm):
        blur = oracle.gaussian_blur(oracle.rgb2mono(noise_frame))
        ex, ey = oracle.sobel_sums(blur)
        expected = oracle.non_max_suppression(ex, ey, norm=norm)
        got = np.asarray(
            xla_ops.non_max_suppression(
                jnp.asarray(ex, jnp.int32), jnp.asarray(ey, jnp.int32), norm=norm
            )
        )
        np.testing.assert_array_equal(got, expected)

    def test_threshold(self, noise_frame):
        blur = oracle.gaussian_blur(oracle.rgb2mono(noise_frame))
        ex, ey = oracle.sobel_sums(blur)
        nms = oracle.non_max_suppression(ex, ey)
        for low, high in [(10, 40), (0, 0), (255, 255), (5, 200)]:
            got = np.asarray(
                xla_ops.double_threshold(jnp.asarray(nms), jnp.int32(low), jnp.int32(high))
            )
            np.testing.assert_array_equal(got, oracle.double_threshold(nms, low, high))

    @pytest.mark.slow
    def test_hysteresis_matches_bfs(self, rng):
        # Random candidate fields: while_loop fixed point == BFS reconstruction.
        for trial in range(5):
            t = rng.choice([0, 128, 255], size=(40, 56), p=[0.6, 0.3, 0.1]).astype(np.uint8)
            got = np.asarray(xla_ops.hysteresis(jnp.asarray(t)))
            np.testing.assert_array_equal(got, oracle.hysteresis(t))

    def test_hysteresis_snake(self):
        # A long snaking candidate path from a single seed: worst-case
        # propagation, must still converge to the BFS answer.
        t = np.zeros((20, 20), np.uint8)
        t[0, 0] = 255
        path = []
        for r in range(20):
            cols = range(20) if r % 2 == 0 else range(19, -1, -1)
            path.extend((r, c) for c in cols)
        for r, c in path[1:]:
            t[r, c] = 128
        got = np.asarray(xla_ops.hysteresis(jnp.asarray(t), max_iters=100, inner_steps=8))
        np.testing.assert_array_equal(got, oracle.hysteresis(t))

    def test_hysteresis_iteration_cap(self):
        # With a tiny cap the fixed point is intentionally truncated:
        # only cap*inner_steps pixels of a chain can be promoted.
        t = np.zeros((3, 64), np.uint8)
        t[1, 0] = 255
        t[1, 1:] = 128
        out, iters = xla_ops.hysteresis(
            jnp.asarray(t), max_iters=2, inner_steps=4, return_iters=True
        )
        out = np.asarray(out)
        assert int(iters) == 2
        assert out[1, 8] == 255 and out[1, 20] == 0

    def test_float2uchar(self):
        x = np.array([[-3.7, 300.0, 12.9]], np.float32)
        got = np.asarray(xla_ops.float2uchar(jnp.asarray(x)))
        np.testing.assert_array_equal(got, oracle.float2uchar(x))


class TestPipelineEquivalence:
    @pytest.mark.parametrize("shape", [(48, 64), (33, 47), (72, 96)])
    def test_all_stages_smooth(self, rng, shape):
        frame = make_bgr_frame(rng, *shape)
        self._check_all(frame, shape)

    def test_all_stages_noise(self, rng):
        frame = make_noise_frame(rng, 40, 52)
        self._check_all(frame, (40, 52))

    def _check_all(self, frame, shape):
        cfg = _cfg(*shape)
        got = jax.jit(
            lambda f, lo, hi: xla_ops.canny_all_stages(f, lo, hi, cfg)
        )(jnp.asarray(frame), jnp.int32(10), jnp.int32(40))
        exp = oracle.canny_pipeline(frame)
        for key in ("mono", "gaussian", "nms", "thresh", "hyster", "gradient_display"):
            np.testing.assert_array_equal(
                np.asarray(got[key]), exp[key], err_msg=f"stage {key} mismatch"
            )
        # Float planes: tight tolerance (atan2/sqrt may differ by ulps).
        np.testing.assert_allclose(np.asarray(got["grad"]), exp["grad"], rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got["slope"]), exp["slope"], rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("stage", list(CannyStage))
    def test_run_to_stage(self, bgr_frame, stage):
        h, w = bgr_frame.shape[:2]
        cfg = _cfg(h, w)
        got = np.asarray(
            jax.jit(
                lambda f, lo, hi: xla_ops.canny_to_stage(f, lo, hi, cfg, stage),
            )(jnp.asarray(bgr_frame), jnp.int32(10), jnp.int32(40))
        )
        exp = oracle.canny_pipeline(bgr_frame)
        key = xla_ops.STAGE_DISPLAY_KEY[stage]
        np.testing.assert_array_equal(got, exp[key])

    @pytest.mark.parametrize("ks,norm", [(3, "l2"), (7, "l2"), (5, "l1")])
    def test_config_variants(self, bgr_frame, ks, norm):
        h, w = bgr_frame.shape[:2]
        cfg = _cfg(h, w, kernel_size=ks, norm=norm)
        got = np.asarray(
            jax.jit(
                lambda f, lo, hi: xla_ops.canny_to_stage(f, lo, hi, cfg, CannyStage.HYSTER),
            )(jnp.asarray(bgr_frame), jnp.int32(10), jnp.int32(40))
        )
        exp = oracle.canny_pipeline(bgr_frame, kernel_size=ks, norm=norm)
        np.testing.assert_array_equal(got, exp["hyster"])

    def test_mono_input(self, rng):
        mono = make_noise_frame(rng, 40, 52, channels=1)
        cfg = _cfg(40, 52, channels=1)
        got = np.asarray(
            jax.jit(
                lambda f, lo, hi: xla_ops.canny_to_stage(f, lo, hi, cfg, CannyStage.HYSTER),
            )(jnp.asarray(mono), jnp.int32(10), jnp.int32(40))
        )
        exp = oracle.canny_pipeline(mono)
        np.testing.assert_array_equal(got, exp["hyster"])

    def test_threshold_is_runtime_arg(self, bgr_frame):
        # Changing thresholds must not retrace: jit cache stays at one entry.
        h, w = bgr_frame.shape[:2]
        cfg = _cfg(h, w)
        fn = jax.jit(lambda f, lo, hi: xla_ops.canny_to_stage(f, lo, hi, cfg, CannyStage.HYSTER))
        f = jnp.asarray(bgr_frame)
        fn(f, jnp.int32(10), jnp.int32(40)).block_until_ready()
        n0 = fn._cache_size()
        fn(f, jnp.int32(30), jnp.int32(90)).block_until_ready()
        assert fn._cache_size() == n0


class TestThresholdMagnitudeBound:
    """threshold_magnitude_bound is the exact inverse of the uint8 display
    magnitude chain: min(255,(isqrt(m)*coeff)//8) > t  <=>  m >= bound."""

    @pytest.mark.parametrize("coeff", [1, 2, 4, 8])
    def test_exhaustive_l2(self, coeff):
        import math
        ts = np.arange(0, 300, dtype=np.int64)
        bounds = np.asarray(
            jax.vmap(lambda t: xla_ops.threshold_magnitude_bound(t, coeff, "l2"))(
                jnp.asarray(ts, jnp.int32)
            )
        ).astype(np.int64)
        # All distinct isqrt transition points in the domain, plus endpoints.
        ms = [0, 1, 2, 2 * 1020 * 1020]
        for s in range(1, 1443):
            ms += [s * s - 1, s * s, s * s + 1]
        ms = np.asarray(sorted(set(m for m in ms if 0 <= m <= 2 * 1020 * 1020)),
                        dtype=np.int64)
        vals = np.minimum(255, np.asarray(
            [math.isqrt(int(m)) for m in ms], dtype=np.int64) * coeff // 8)
        for t, b in zip(ts, bounds):
            np.testing.assert_array_equal(vals > t, ms >= b)

    @pytest.mark.parametrize("coeff", [1, 4, 8])
    def test_exhaustive_l1(self, coeff):
        ts = np.arange(0, 300, dtype=np.int64)
        bounds = np.asarray(
            jax.vmap(lambda t: xla_ops.threshold_magnitude_bound(t, coeff, "l1"))(
                jnp.asarray(ts, jnp.int32)
            )
        ).astype(np.int64)
        ms = np.arange(0, 2041, dtype=np.int64)
        vals = np.minimum(255, ms * coeff // 8)
        for t, b in zip(ts, bounds):
            np.testing.assert_array_equal(vals > t, ms >= b)

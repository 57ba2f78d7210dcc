"""Engine layer tests: spec locking, thresholds, profiling, batching."""
import numpy as np
import pytest

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.engine import CannyEngine
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.utils.timer import TimerManager

from conftest import make_bgr_frame


@pytest.fixture(scope="module")
def engine():
    return CannyEngine(CannyConfig(height=48, width=64))


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    return make_bgr_frame(rng, 48, 64)


class TestSpecLock:
    def test_wrong_shape_rejected(self, engine):
        with pytest.raises(ValueError, match="specs differ"):
            engine.process(np.zeros((32, 32, 3), np.uint8))

    def test_wrong_dtype_rejected(self, engine):
        with pytest.raises(ValueError, match="uint8"):
            engine.process(np.zeros((48, 64, 3), np.float32))

    def test_empty_rejected(self, engine):
        with pytest.raises(ValueError, match="empty"):
            engine.process(np.zeros((0,), np.uint8))

    def test_mono_engine_accepts_2d(self):
        e = CannyEngine(CannyConfig(height=8, width=8, channels=1))
        out = e.process(np.zeros((8, 8), np.uint8))
        assert out.shape == (8, 8)


class TestThresholds:
    def test_defaults(self, engine):
        assert engine.get_low_threshold() == 10
        assert engine.get_high_threshold() == 40

    def test_clamping(self):
        e = CannyEngine(CannyConfig(height=8, width=8))
        e.set_low_threshold(90)  # clamped to high (40)
        assert e.get_low_threshold() == 40
        e.set_high_threshold(5)  # clamped to low (40)
        assert e.get_high_threshold() == 40
        e.set_high_threshold(200)
        assert e.get_high_threshold() == 200

    def test_threshold_changes_affect_output(self, engine, frame):
        engine.set_low_threshold(10)
        engine.set_high_threshold(40)
        out_default = np.asarray(engine.process(frame, CannyStage.THRESH))
        engine.set_high_threshold(255)
        engine.set_low_threshold(255)
        out_max = np.asarray(engine.process(frame, CannyStage.THRESH))
        assert out_max.sum() == 0  # nothing exceeds 255 strictly
        assert out_default.sum() > 0
        engine.set_low_threshold(10)
        engine.set_high_threshold(40)


class TestCorrectness:
    @pytest.mark.parametrize("stage", list(CannyStage))
    def test_matches_oracle(self, engine, frame, stage):
        from cudacam_tpu.ops import xla_ops

        got = np.asarray(engine.process(frame, stage))
        exp = oracle.canny_pipeline(frame)[xla_ops.STAGE_DISPLAY_KEY[stage]]
        np.testing.assert_array_equal(got, exp)

    def test_process_all(self, engine, frame):
        res = engine.process_all(frame)
        exp = oracle.canny_pipeline(frame)
        np.testing.assert_array_equal(np.asarray(res["hyster"]), exp["hyster"])
        assert set(res) >= {"mono", "gaussian", "grad", "slope", "nms", "thresh", "hyster"}


class TestBatching:
    def test_batched_matches_single(self, engine, frame):
        batch = np.stack([frame, frame[:, ::-1], 255 - frame])
        out = np.asarray(engine.process(batch))
        assert out.shape == (3, 48, 64)
        for i in range(3):
            np.testing.assert_array_equal(out[i], np.asarray(engine.process(batch[i])))


class TestProfiling:
    def test_profiled_run_matches_and_times(self, frame):
        timers = TimerManager()
        e = CannyEngine(
            CannyConfig(height=48, width=64),
            profiling=True,
            timers=timers,
        )
        out_prof = np.asarray(e.process(frame))
        e.set_profiling(False)
        out_fused = np.asarray(e.process(frame))
        np.testing.assert_array_equal(out_prof, out_fused)
        # All six stages recorded.
        recorded = {name for name, _, count in timers.items() if count > 0}
        assert len(recorded) == 6
        table = e.profiling_table()
        assert "TOTAL" in table and "6/6 Hysteresis" in table

    def test_toggle(self, engine):
        assert not engine.is_profiling_enabled()
        engine.set_profiling(True)
        assert engine.is_profiling_enabled()
        engine.set_profiling(False)

    @pytest.mark.slow
    def test_profiled_batched(self, frame):
        e = CannyEngine(
            CannyConfig(height=48, width=64),
            profiling=True,
            timers=TimerManager(),
        )
        batch = np.stack([frame, frame])
        out = np.asarray(e.process(batch))
        assert out.shape == (2, 48, 64)
        np.testing.assert_array_equal(out[0], out[1])


class TestWarmup:
    def test_warmup_compiles(self, engine):
        engine.warmup()
        engine.warmup(CannyStage.MONO)


class TestCumulativeProfiling:
    """Profiling on the production programs: the cumulative mode times the
    engine's own run-to-stage-k programs instead of the stage-split XLA
    ops."""

    def test_cumulative_mode_times_and_matches(self, frame):
        timers = TimerManager()
        e = CannyEngine(
            CannyConfig(height=48, width=64),
            profiling=True,
            timers=timers,
        )
        e.profiling_mode = "cumulative"
        out_prof = np.asarray(e.process(frame))
        e.set_profiling(False)
        out_plain = np.asarray(e.process(frame))
        np.testing.assert_array_equal(out_prof, out_plain)
        recorded = {name for name, _, count in timers.items() if count > 0}
        assert len(recorded) == 6  # all six stages attributed
        assert "TOTAL" in e.profiling_table()

    def test_auto_mode_resolution(self):
        e = CannyEngine(CannyConfig(height=8, width=8))
        assert e.profiling_mode == "stages"  # the default
        e.profiling_mode = "cumulative"
        assert e.profiling_mode == "cumulative"

    def test_device_mode_times_and_matches(self, frame):
        """profiling_mode='device' samples per-stage device-lane time once
        (the host clock on CPU, where no device lane exists) and then
        streams at production speed. Output must equal
        the unprofiled path bit-for-bit."""
        timers = TimerManager()
        e = CannyEngine(
            CannyConfig(height=48, width=64),
            profiling=True,
            timers=timers,
        )
        e.profiling_mode = "device"
        out_prof = np.asarray(e.process(frame))
        # Second frame reuses the sample (no re-trace) and still matches.
        out_again = np.asarray(e.process(frame))
        e.set_profiling(False)
        out_plain = np.asarray(e.process(frame))
        np.testing.assert_array_equal(out_prof, out_plain)
        np.testing.assert_array_equal(out_again, out_plain)
        recorded = {name for name, _, count in timers.items() if count > 0}
        assert len(recorded) == 6  # all six stages attributed once
        assert "TOTAL" in e.profiling_table()


class TestThresholdCacheByValue:
    def test_stale_cache_never_served(self, frame):
        """The device-scalar cache is keyed BY VALUE: even a stale cache
        tuple (the lost-update race with concurrent /set callers) cannot
        be served once the values differ."""
        e = CannyEngine(CannyConfig(height=48, width=64))
        lo, hi = e._thresholds()
        assert int(lo) == 10 and int(hi) == 40
        e.set_low_threshold(20)
        lo2, _ = e._thresholds()
        assert int(lo2) == 20
        # Simulate a racing writer clobbering the cache with stale values:
        e._thresh_dev = (10, 40, lo, hi)
        e._low = 25
        lo3, _ = e._thresholds()
        assert int(lo3) == 25


class TestResilientJit:
    """The AOT fallback for the jax 0.9 fastpath dispatch bug
    (engine._ResilientJit): on the specific "buffers but compiled program
    expected" ValueError, the wrapper must permanently switch that argument
    signature to an AOT-compiled executable; any other error propagates."""

    class _FlakyJit:
        """Mimics a jit object whose fastpath entry went inconsistent:
        every __call__ raises the deployment's dispatch error, while
        lower().compile() (the AOT route) keeps working."""

        def __init__(self):
            self.calls = 0
            self.aot_compiles = 0

        def __call__(self, *args):
            self.calls += 1
            raise ValueError(
                "Execution supplied 3 buffers but compiled program "
                "expected 4 buffers"
            )

        def lower(self, *args):
            outer = self

            class _Lowered:
                def compile(self):
                    outer.aot_compiles += 1
                    return lambda *a: a[0] + a[1]

            return _Lowered()

    def test_fallback_switches_to_aot_and_sticks(self):
        from cudacam_tpu.engine.engine import _ResilientJit
        import jax.numpy as jnp

        flaky = self._FlakyJit()
        r = _ResilientJit(flaky)
        a, b = jnp.int32(2), jnp.int32(3)
        assert int(r(a, b)) == 5          # falls back, returns AOT result
        assert flaky.aot_compiles == 1
        assert int(r(a, b)) == 5          # cached AOT: no new compile,
        assert flaky.aot_compiles == 1    # no retry through the bad path
        assert flaky.calls == 1
        # A different signature goes through the jit again (and falls
        # back independently).
        assert int(r(jnp.float32(1.5), jnp.float32(2.5))) == 4
        assert flaky.aot_compiles == 2 and flaky.calls == 2

    def test_unrelated_errors_propagate(self):
        from cudacam_tpu.engine.engine import _ResilientJit

        class _Broken:
            def __call__(self, *args):
                raise ValueError("something else entirely")

        r = _ResilientJit(_Broken())
        with pytest.raises(ValueError, match="something else"):
            r(1)

    def test_tracers_route_through_the_real_jit(self):
        from cudacam_tpu.engine.engine import _ResilientJit
        import jax
        import jax.numpy as jnp

        seen = []

        def fn(x):
            seen.append(type(x).__name__)
            return x * 2

        r = _ResilientJit(fn)
        out = jax.jit(lambda x: r(x))(jnp.int32(4))
        assert int(out) == 8
        # Inside the outer trace the wrapper must not try AOT routes.
        assert not r._aot

"""The engine's XLA path against the NumPy oracle over algorithm variants,
batching and threshold sweeps — the CPU side of what chip_smoke.py checks
on the GPU at full size."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.engine import CannyEngine
from cudacam_tpu.ops import numpy_oracle as oracle

from conftest import EXACT_KEYS, assert_all_stages_match_oracle, make_test_frame


@pytest.mark.parametrize("parity", ["reference", "opencv"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("kernel_size", [3, 5, 7])
def test_algorithm_variants_match_oracle(kernel_size, norm, parity):
    frame = make_test_frame(40, 56, 3, seed=kernel_size)
    cfg = CannyConfig(height=40, width=56, kernel_size=kernel_size,
                      norm=norm, parity=parity)
    low, high = (10, 40) if parity == "reference" else (60, 180)
    assert_all_stages_match_oracle(cfg, frame, low, high)


@pytest.mark.parametrize("stage", [s.name for s in CannyStage] + ["ALL"])
def test_batched_equals_per_frame(stage):
    """A (B, H, W, C) batch runs the vmapped program; every frame must equal
    its own single-frame call, for every final stage and process_all."""
    eng = CannyEngine(CannyConfig(height=24, width=40))
    frames = np.stack([make_test_frame(24, 40, 3, seed=s) for s in range(3)])
    if stage == "ALL":
        got = eng.process_all(frames)
        for i in range(3):
            single = eng.process_all(frames[i])
            for k in EXACT_KEYS:
                np.testing.assert_array_equal(
                    np.asarray(got[k][i]), np.asarray(single[k]), err_msg=k)
        return
    got = np.asarray(eng.process(frames, CannyStage[stage]))
    assert got.shape == (3, 24, 40)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(eng.process(frames[i], CannyStage[stage])))


def test_threshold_sweep_matches_oracle():
    eng = CannyEngine(CannyConfig(height=32, width=48))
    frame = make_test_frame(32, 48, 3, seed=5)
    lows, highs = [5, 10, 20, 40], [20, 40, 80, 120]
    maps, counts = eng.threshold_sweep(frame, lows, highs)
    nms = oracle.canny_pipeline(frame)["nms"]
    for k, (lo, hi) in enumerate(zip(lows, highs)):
        want = oracle.hysteresis(oracle.double_threshold(nms, lo, hi))
        np.testing.assert_array_equal(np.asarray(maps[k]), want)
        assert int(counts[k]) == int((want == 255).sum())


def test_engine_runs_on_default_device():
    """No device selection logic remains: the compiled program runs where
    JAX puts its inputs."""
    eng = CannyEngine(CannyConfig(height=16, width=16))
    out = eng.process(jnp.zeros((16, 16, 3), jnp.uint8))
    assert out.devices() == {jax.devices()[0]}

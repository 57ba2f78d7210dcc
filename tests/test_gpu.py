"""On-card tests: they need a GPU and skip without one (the ``gpu`` fixture
decides at run time). Run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""
import numpy as np
import pytest

import jax

from cudacam_tpu import CannyConfig
from cudacam_tpu.engine import CannyEngine
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.utils import devtime

pytestmark = pytest.mark.gpu


def test_1080p_edge_map_bit_exact(gpu):
    frame = make_scene(1080, 1920, seed=7)
    out = CannyEngine(CannyConfig(height=1080, width=1920)).process(frame)
    assert out.devices() == {gpu}
    np.testing.assert_array_equal(
        np.asarray(out), oracle.canny_pipeline(frame)["hyster"])


def test_device_busy_time_from_a_real_trace(gpu):
    eng = CannyEngine(CannyConfig(height=1080, width=1920))
    frame = jax.device_put(make_scene(1080, 1920, seed=8))
    jax.block_until_ready(eng.process(frame))
    ms = devtime.device_time_ms_per_call(
        lambda: jax.block_until_ready(eng.process(frame)), calls=3)
    assert ms is not None and 0 < ms < 1000


def test_chip_smoke_phases_small_on_the_card(gpu):
    import chip_smoke

    chip_smoke.phase_stream(64, 96, n=2)
    chip_smoke.phase_all_stages(64, 96)
    chip_smoke.phase_batch_sweep(64, 96, b=2)

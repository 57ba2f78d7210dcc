"""Test configuration.

Tests run on the CPU with 8 virtual XLA devices, so the multi-device
sharding path is exercised without a GPU. ``JAX_PLATFORMS`` defaults to
``cpu``; tests marked ``gpu`` need a card and skip without one (run them
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``, see the
README).
"""
import os

# Must happen before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from cudacam_tpu.utils.compile_cache import ENV_VAR, enable_compile_cache  # noqa: E402

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR when set, else
# the checkout's .jax_cache/). Set CUDACAM_TEST_COMPILE_CACHE= (empty) to
# disable it.
if os.environ.get("CUDACAM_TEST_COMPILE_CACHE", "1"):
    enable_compile_cache()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mmap_growth():
    """Clear jax's executable caches between test modules.

    Root cause (diagnosed by polling /proc/<pid>/maps during a full
    run): every compiled executable holds JIT'd code in mmap'd regions
    and the process-global caches keep them all alive, so the full suite
    crosses the default vm.max_map_count (65530) around the ~200-test
    mark — at which point mmap failures SEGFAULT LLVM inside
    backend_compile_and_load (and, with the persistent cache enabled,
    inside its zstd (de)serialization). Observed as nondeterministic
    full-suite-only crashes whose location moved with test ordering;
    every affected test passes standalone. Dropping the caches per
    module munmaps dead executables and bounds the map count; modules
    recompile their own shapes anyway, so the wall-time cost is small.
    """
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    here, at run time, never while a module is imported (every xdist
    worker must collect the same tests)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {devs[0].platform})")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_bgr_frame(rng, h, w):
    """Random-but-smooth BGR frame: random low-res field upsampled, so it has
    realistic gradients rather than salt-and-pepper noise."""
    small = rng.integers(0, 256, size=(max(2, h // 8), max(2, w // 8), 3), dtype=np.uint8)
    reps_y = -(-h // small.shape[0])
    reps_x = -(-w // small.shape[1])
    big = np.repeat(np.repeat(small, reps_y, axis=0), reps_x, axis=1)[:h, :w]
    return np.ascontiguousarray(big)


def make_noise_frame(rng, h, w, channels=3):
    shape = (h, w, channels) if channels == 3 else (h, w)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.fixture(scope="session")
def bgr_frame(rng):
    return make_bgr_frame(rng, 72, 96)


@pytest.fixture(scope="session")
def noise_frame(rng):
    return make_noise_frame(rng, 48, 64)


#: uint8 buffers of process_all, each bit-exact against the oracle.
EXACT_KEYS = ("mono", "gaussian", "gradient_display", "nms", "thresh", "hyster")


def make_test_frame(h, w, channels, seed=0):
    f = make_bgr_frame(np.random.default_rng(seed), h, w)
    return f if channels == 3 else f[..., 1].copy()


def assert_all_stages_match_oracle(cfg, frame, low=10, high=40):
    """Every uint8 buffer of CannyEngine.process_all equals the oracle."""
    from cudacam_tpu.engine import CannyEngine
    from cudacam_tpu.ops import numpy_oracle as oracle

    eng = CannyEngine(cfg.with_thresholds(low, high))
    got = eng.process_all(frame)
    want = oracle.canny_pipeline(
        frame, low=low, high=high, kernel_size=cfg.kernel_size,
        grad_coeff=cfg.grad_coeff, norm=cfg.norm, parity=cfg.parity,
    )
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)

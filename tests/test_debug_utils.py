"""Tests for the debug/validation utilities (the sanitizer analog)."""
from __future__ import annotations

import numpy as np
import pytest

from cudacam_tpu.utils.debug import (
    DeviceError,
    device_health_check,
    disable_checks,
    enable_checks,
)


def test_health_check_passes():
    assert device_health_check() in ("cpu", "gpu")


def test_enable_disable_checks_roundtrip():
    import jax

    enable_checks()
    assert jax.config.jax_debug_nans
    assert jax.config.jax_enable_checks
    disable_checks()
    assert not jax.config.jax_debug_nans


def test_nan_check_catches_nan():
    import jax
    import jax.numpy as jnp

    enable_checks(invariant_checks=False)
    try:
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.float32(-1.0)).block_until_ready()
    finally:
        disable_checks()

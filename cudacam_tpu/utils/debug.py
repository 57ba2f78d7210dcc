"""Debug / validation modes — the sanitizer analog.

The reference ships opt-in sanitizers (ASan/LSan/UBSan/TSan/MSan, reference
cmake/Sanitizers.cmake:13-47) and clang-tidy/cppcheck hooks; its CUDA error
contract is fail-fast (`checkCudaErrors` logs and exits, helper.hpp:4-17).
The analogs here:

* ``enable_checks()`` — turn on JAX's runtime validators (NaN checks and
  internal invariant checks) for a debugging session;
* ``device_health_check()`` — fail-fast canary: run a tiny computation and
  verify the result, raising ``DeviceError`` with the platform context if
  the device is wedged (the `checkCudaErrors` role — surfacing device
  failure at a defined boundary instead of deep inside a stream loop).

Enable ``CUDACAM_DEBUG=1`` to switch checks on at import.
"""
from __future__ import annotations

import os

from cudacam_tpu.utils.logging import get_logger

log = get_logger("debug")


class DeviceError(RuntimeError):
    """Raised when the accelerator fails its health canary."""


def enable_checks(nan_checks: bool = True, invariant_checks: bool = True) -> None:
    """Enable JAX runtime validation (debug sessions only: NaN checks force
    per-op synchronisation, like the reference's per-stage profiling sync)."""
    import jax

    if nan_checks:
        jax.config.update("jax_debug_nans", True)
    if invariant_checks:
        jax.config.update("jax_enable_checks", True)
    log.info("debug checks enabled (nan=%s, invariants=%s)",
             nan_checks, invariant_checks)


def disable_checks() -> None:
    import jax

    jax.config.update("jax_debug_nans", False)
    jax.config.update("jax_enable_checks", False)


def device_health_check() -> str:
    """Fail-fast canary computation; returns the platform name on success."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    try:
        devs = jax.devices()
        if not devs:
            raise DeviceError("no accelerator devices visible")
        x = jnp.arange(256, dtype=jnp.int32).reshape(16, 16)
        got = np.asarray(jax.jit(lambda a: (a * 2 + 1).sum())(x))
        expect = np.arange(256, dtype=np.int64).sum() * 2 + 256
        if int(got) != int(expect):
            raise DeviceError(
                f"canary mismatch on {devs[0]}: got {got}, want {expect}"
            )
        return devs[0].platform
    except DeviceError:
        raise
    except Exception as e:  # surface with context, fail fast
        raise DeviceError(f"device health check failed: {e}") from e


if os.environ.get("CUDACAM_DEBUG"):
    enable_checks()

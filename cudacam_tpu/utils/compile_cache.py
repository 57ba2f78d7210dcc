"""Where the persistent XLA compile cache lives.

One rule for every entry point (the CLI, bench.py, chip_smoke.py and the
tests): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here changes any setting; otherwise the cache lives at a fixed path
inside the checkout, ``.jax_cache/`` (listed in .gitignore). The path is part
of what makes a later run find the cache, so it never comes from a temp
name, a pid or the clock.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory and return the
    directory. Idempotent; call before the first compile."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR

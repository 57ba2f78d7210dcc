"""The compile-cache location rule (utils/compile_cache.py)."""
import os

import jax
import pytest

from cudacam_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "c"))
    assert cc.enable_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()  # JAX creates it, not the helper


def test_unset_uses_the_checkout_directory(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    path = cc.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("calls", [2, 3])
def test_path_is_stable(monkeypatch, calls):
    """No pid, temp name or time in the path: every call, in any process,
    names the same directory (it is listed in .gitignore)."""
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    paths = {cc.enable_compile_cache() for _ in range(calls)}
    assert paths == {cc.CHECKOUT_CACHE_DIR}
    assert str(os.getpid()) not in cc.CHECKOUT_CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

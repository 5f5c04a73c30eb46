"""The CLI's persistent compilation cache location
(utils/compile_cache.py)."""

import os

import jax
import pytest

from taxor_jax.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      before[1])


def test_environment_variable_wins(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing is set in code: JAX itself reads the variable
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_fixed_checkout_path(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # independent of the working directory and of HOME
    monkeypatch.chdir("/")
    monkeypatch.setenv("HOME", "/nonexistent")
    assert compile_cache.enable_compile_cache() == want

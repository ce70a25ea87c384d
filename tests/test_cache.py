"""Persistent compile cache placement (utils/cache.py)."""

import os

import jax
import pytest

from ucoslam_tpu.utils import cache

_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


@pytest.fixture
def restore_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_from_environment(monkeypatch, restore_config, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the code sets
    no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == -1


def test_cache_dir_default_in_checkout(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(root, ".jax_cache")
    assert cache.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected

"""Persistent XLA compilation cache (shared by apps, bench and chip_smoke).

First compiles of the full-size programs take seconds each (and each shape
bucket compiles anew); the on-disk cache lets later runs and processes start
hot. Apps call enable_compile_cache() before building a System.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets no directory. Otherwise the cache lives at the checkout's fixed
`.jax_cache/`: the path is part of the cache key, so it must not move.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = _DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # persist every program: a SLAM session dispatches hundreds of small
    # ones, and a compile-time threshold would recompile most of them
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir

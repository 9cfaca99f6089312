"""Persistent XLA compilation cache, one rule for every entry point."""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache is the checkout's
    `.jax_cache/`. Every program is cached, however small or quick to
    compile: the vision path compiles dozens of small host-side programs.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path

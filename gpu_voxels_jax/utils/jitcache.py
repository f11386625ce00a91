"""Persistent XLA compilation cache setup.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this module
sets no cache directory of its own. Otherwise the cache lives at the fixed
path `<repo>/.jax_cache` (gitignored), so repeat runs from one checkout find
their compiled programs again: the path is part of what a cache entry is
keyed on, so a directory that moves never hits.
"""
from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str:
    """Point JAX at the persistent compilation cache; returns the directory.

    Safe to call multiple times and before or after backend initialisation
    (JAX only consults the setting when it compiles)."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache programs that took >= 1 s to compile; trivial ones are not worth
    # the disk
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir

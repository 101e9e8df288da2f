"""Persistent XLA compilation cache for the device paths.

A fresh process pays every jit compile again; with the cache, a compile is
paid once per cache directory. ``JAX_COMPILATION_CACHE_DIR``, when set, is
used as JAX itself reads it and no other directory is set here. Otherwise
the cache lives at a fixed path inside the checkout (``<repo>/.jax_cache``):
the directory is part of the cache key, so a path that moves never hits.

There is no reference counterpart — the reference's Python hot loop has no
compilation step.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = str(Path(__file__).resolve().parent.parent / ".jax_cache")


def enable_persistent_cache() -> str | None:
    """Turn on JAX's on-disk compilation cache; idempotent.

    Caches every entry regardless of size or compile time. Returns the
    cache directory, or None when the default one cannot be created (a
    read-only checkout) — callers then proceed uncached.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(DEFAULT_DIR, exist_ok=True)
        except OSError:
            return None
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return jax.config.jax_compilation_cache_dir

"""Persistent XLA compilation cache.

A fresh process compiles every program it runs; the reference tool has no
analogous cost. JAX's persistent compilation cache lets every later process
load those programs instead. On by default for accelerator backends; opt
out with SPECTRAL_TPU_NO_CACHE=1.

Placement: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads that
directory itself and this module sets no other. Otherwise the cache lives at
the fixed ``<checkout>/.jax_cache`` (gitignored) — a fixed path, because the
directory is part of what later processes look up.
"""

from __future__ import annotations

import os

_enabled = False

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the repository root holding this package."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compilation_cache() -> bool:
    """Idempotently enable the persistent compilation cache. Returns whether
    the cache is active."""
    global _enabled
    if _enabled:
        return True
    if os.environ.get("SPECTRAL_TPU_NO_CACHE"):
        return False
    try:
        import jax
        # Only persist accelerator programs. Caching XLA:CPU AOT blobs
        # across processes trips machine-feature mismatch checks (and risks
        # SIGILL per XLA's own warning), and CPU compiles are cheap anyway.
        if jax.default_backend() == "cpu":
            return False
        if not os.environ.get(ENV_DIR):
            cache_dir = default_cache_dir()
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        # every accelerator program persists, not only those above JAX's
        # 1 s default: most of this package's GPU programs compile in well
        # under a second each, and a cold process compiles dozens of them
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        _enabled = True
        return True
    except Exception:
        return False


def compilation_cache_dir() -> str | None:
    """The active persistent-cache directory, or None when caching is off.

    Bench artifacts record this so a slow `warmup_s` can be attributed to a
    cold cache."""
    if not _enabled:
        return None
    import jax
    return jax.config.jax_compilation_cache_dir

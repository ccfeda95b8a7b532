"""Persistent XLA compile cache for the scripts that run on the GPU.

``chip_smoke.py`` and ``bench.py`` call :func:`enable_compile_cache` before
their first compilation; importing ``linops_tpu`` never touches the cache.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

# <repo>/.jax_cache: a fixed path, because the path is part of the cache key
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Return the directory JAX keeps compiled programs in.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache goes to ``DEFAULT_CACHE_DIR``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR

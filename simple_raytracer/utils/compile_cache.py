"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
alone.  Otherwise the cache goes to ``<repo>/.jax_cache`` (git-ignored): a
fixed path, since the path is part of the cache key.  Entry points (the
CLI, bench.py, chip_smoke.py) call :func:`enable_compile_cache` before
their first compile.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point the persistent cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE

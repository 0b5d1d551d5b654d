"""Persistent compilation cache for scripts that drive the package.

Entry-point scripts (``chip_smoke.py``, ``bench.py``, ``benchmarks/*``,
``examples/*``) call :func:`enable_compile_cache` once before their first
compile; importing ``lynx_tpu`` never touches the cache.  The flagship's
first compile takes seconds, and a cache hit skips it on the next run.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: Fixed cache location inside the checkout (listed in ``.gitignore``).
#: The path is part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it as
    ``jax_compilation_cache_dir`` and this sets nothing; otherwise the
    cache goes to :data:`DEFAULT_CACHE_DIR`.
    """
    from_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if from_env:
        return from_env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)

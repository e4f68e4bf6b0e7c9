"""JAX persistent compilation cache for the entry points.

Entry points (``chip_smoke.py``, ``bench.py``, ``demo.py``, ``tools.detect``,
``tools.serve_fleet``) call :func:`enable_compile_cache` before their first
compile; importing the package sets nothing.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else is set.
* unset: the cache goes to ``<repo>/.jax_cache`` (gitignored).  The path is
  fixed — the cache directory is part of what a later process looks up, so a
  path derived from a pid, a temp name or the time would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)

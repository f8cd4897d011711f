"""Persistent compilation cache: one place decides where it lives.

Every entry point (bench.py, the CLI, chip_smoke.py, benchmarks/*.py) calls
:func:`enable` before its first compilation.  ``JAX_COMPILATION_CACHE_DIR``
wins when it is set: JAX reads it itself and nothing here overrides it.
Otherwise the cache sits at the fixed path ``<repo>/.jax_cache`` — fixed
because the directory is part of the cache's key, so a per-process or
temporary name would never hit.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns its directory.  With the
    variable set this changes nothing: JAX has already read it."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return os.environ.get(ENV_VAR) or DEFAULT_DIR

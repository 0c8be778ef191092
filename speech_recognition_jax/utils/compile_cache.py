"""JAX persistent compilation cache location.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` once at start-up; importing the package
changes no JAX setting.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["compile_cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# the checkout that holds this package (listed in .gitignore there)
_CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=None) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(_CHECKOUT_CACHE)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory.  Where the
    environment variable is set, JAX already reads it, so no directory
    is set here."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path

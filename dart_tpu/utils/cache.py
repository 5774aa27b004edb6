"""The persistent compile cache, set the same way by every entry point."""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
# `.jax_cache/` at the root of the checkout (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when it is set, else `.jax_cache/`."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Persistent XLA compile cache location, shared by every entry point
(run.py, bench.py, chip_smoke.py)."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.cache/jax."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".cache", "jax"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return that directory. Call before the first compilation."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

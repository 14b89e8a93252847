"""One place for JAX's persistent compilation cache.

Compiling the 1080p programs is a large share of a cold run on the GPU, so
every entry point (``cli.main``, ``bench.py``, ``bench_all.py``,
``chip_smoke.py``) calls :func:`configure_compile_cache` before its first
compile.  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself: when that variable
is set (even to the empty string, which disables the cache) nothing is set
here.  Otherwise the cache lives at the fixed path ``<checkout>/.jax_cache``
— fixed, because a cache directory that moves between runs never hits.
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "configure_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point the persistent compilation cache at its one directory and
    return that directory ('' when the environment disables the cache)."""
    if ENV_VAR in os.environ:
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR

"""Persistent JAX compilation cache setup.

A fresh process compiles every distinct executable again; the persistent
cache serializes compiled executables to disk so later processes load
them instead.  The cache key includes the directory, so the directory
must not move between runs: it is ``JAX_COMPILATION_CACHE_DIR`` when
that is set (JAX reads the variable itself, and no other directory is
set here), and otherwise one fixed directory inside the checkout.

Call :func:`enable` once, after importing jax, before the first jit
execution.
"""

from __future__ import annotations

import os

#: the in-checkout default (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path

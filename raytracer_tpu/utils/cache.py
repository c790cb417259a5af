"""Persistent XLA compilation cache setup.

The persistent cache turns identical-program recompiles into disk hits
across processes (progressive resume, bench reruns, the test workers).

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
module sets no directory.  Otherwise the cache lives at one fixed path
inside the checkout (`<repo>/.jax_cache`, git-ignored): the path is part
of what a later process must find again, so it never depends on a temp
name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory compiled programs are cached in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> None:
    import jax

    if not os.environ.get(ENV_VAR):
        try:
            os.makedirs(DEFAULT_DIR, exist_ok=True)
        except OSError:
            return  # read-only checkout: run uncached
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

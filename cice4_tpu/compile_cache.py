"""Where the persistent XLA compilation cache lives.

The one place that chooses the cache directory for the package, the
benchmark, the smoke script, the tests and the tools:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this
  module changes nothing.
* otherwise: a fixed directory inside the checkout (``.jax_cache``,
  listed in ``.gitignore``).  The path is part of the cache key, so it
  is never derived from a temp name, a pid or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return DEFAULT_DIR


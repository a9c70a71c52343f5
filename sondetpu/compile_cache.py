"""Where the persistent XLA compile cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, that
setting stands. Otherwise the cache goes to one fixed directory of the
checkout, ``<checkout>/.jax_cache`` (listed in .gitignore): the path is part
of the cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    path = os.environ.get(ENV)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

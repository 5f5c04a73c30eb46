"""JAX's persistent compilation cache for the command-line entry points.

The fused search graphs take seconds to compile per (rows, length)
bucket; the on-disk cache makes a repeated ``taxor search`` over the same
index geometry start without recompiling.
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache: a fixed path, so cache keys stay stable between
# runs from the same checkout (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here; otherwise the cache lives at DEFAULT_DIR."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR

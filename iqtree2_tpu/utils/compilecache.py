"""Where JAX's persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, names the directory and nothing
else is set. Otherwise the cache is ``<checkout>/.jax_cache``: a fixed
path, because the cache directory is part of what a later process must
find again, so a name built from a temp dir, a user id, a pid or the time
would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def default_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache(min_compile_secs: float = 0.5) -> str | None:
    """Point JAX's persistent compile cache at ``default_cache_dir()``.

    Returns the directory, or None when it cannot be created (the cache
    is an optimization only)."""
    import jax
    path = default_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path

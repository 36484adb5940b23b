"""Where JAX keeps its persistent compilation cache.

Every entry point (the engines, and through them the CLIs; ``bench.py``;
``chip_smoke.py``) calls :func:`enable_compile_cache` so that compiled
programs land in one directory, and a later process finds them there.
"""

import os
import pathlib

import jax

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache():
    """Point the persistent compilation cache at one directory; return it.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set, and no other path is
    set then.  Otherwise the cache is ``.jax_cache`` at the root of the
    checkout, which ``.gitignore`` lists.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path

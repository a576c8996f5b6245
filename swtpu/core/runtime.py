"""Process-level runtime settings shared by every entry point.

One place decides where compiled XLA programs are cached: the directory
named by ``JAX_COMPILATION_CACHE_DIR`` when it is set, else the fixed
``<checkout>/.jax_cache`` (listed in .gitignore). A fixed path matters
because the path is part of the cache's key: a directory that moves never
hits. ``python -m swtpu``, ``bench.py``, ``chip_smoke.py`` and the test
suite all call `enable_compile_cache`; nothing else sets a cache path.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent.parent


def compile_cache_dir() -> Path:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else CHECKOUT / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path

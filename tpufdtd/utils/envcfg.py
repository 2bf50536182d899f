"""Process settings from the environment.

  TPUFDTD_STORAGE   float32 | bfloat16 — storage dtype of the CLI perf phase
                    (the reference's env-routed FDTD_* hook, main.cpp:82-84)

`enable_compile_cache` places JAX's persistent compilation cache: where
`JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing is set
here; otherwise the cache goes to `<checkout>/.jax_cache`, a fixed path, so
later processes of the same checkout find it again.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def storage_dtype() -> str:
    return os.environ.get("TPUFDTD_STORAGE", "float32")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it.
    Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR

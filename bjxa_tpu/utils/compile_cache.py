"""Where the persistent XLA compilation cache lives.

Large decode/encode programs cost seconds to compile
(:func:`bjxa_tpu.ops.decode.pad_bucket` bounds how many shapes exist), so
every entry point keeps compiled programs on disk.  ``JAX_COMPILATION_CACHE_DIR``,
when set, is the cache (JAX reads it itself); otherwise the cache is the
fixed directory :data:`CACHE_DIR` inside the checkout, which git ignores.
"""

from __future__ import annotations

import os
import pathlib

#: The in-checkout cache directory used when ``JAX_COMPILATION_CACHE_DIR``
#: is unset.
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_time_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Programs that compile faster than ``min_compile_time_secs`` are not
    cached.
    """
    import jax

    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)

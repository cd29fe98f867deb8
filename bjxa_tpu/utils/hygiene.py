"""Compiled-executable and allocator hygiene for long-lived processes.

Every distinct (mesh, shape, bits, ...) combination this engine compiles
stays resident: XLA:CPU JIT-maps code pages per loaded executable, the
package memoizes its shard_map wrappers (``parallel/sharded.py``), and
glibc keeps freed arena pages mapped.  A process that walks many shapes
(a long-running service, or the full ``--slow`` test suite) accumulates
virtual mappings until ``mmap`` starts failing against the kernel's
``vm.max_map_count`` — and an mmap failure inside XLA's executable
(de)serializer is a hard SIGSEGV, not a Python error.  Measured on the
round-5 suite: the map count climbed past 64k of the default 65530
ceiling and the run segfaulted inside ``compilation_cache.
get_executable_and_time``.

:func:`clear_compiled_caches` releases all three layers.  Safe at any
quiescent point — everything recompiles (or reloads from the persistent
compilation cache) on next use; results are unaffected.  The test
harness calls it between modules; services converting heterogeneous
corpora should call it periodically.

The reference C library has no analog only because it compiles nothing
at runtime; this is the device-side counterpart of its "no global state"
rule (``/root/reference/src/libbjxa.c`` keeps all state in the decoder
object): compiled code is the one global this engine holds, and this is
the lever that drops it.
"""

from __future__ import annotations

import gc


def _package_lru_caches():
    """The package's memoized compiled-wrapper builders (lazy import —
    this module must stay importable before jax is configured)."""
    from bjxa_tpu.parallel import sharded

    return (
        sharded._corpus_lanes_fn,
        sharded._corpus_words_fn,
        sharded._corpus_encode_fn,
        sharded._file_sharded_fn,
        sharded._file_sharded_encode_fn,
    )


def clear_compiled_caches(trim_malloc: bool = True) -> None:
    """Drop every compiled executable and memoized wrapper the package
    holds, then collect garbage and (on glibc) return freed arena pages
    to the kernel.

    Args:
      trim_malloc: also call ``malloc_trim(0)`` where available, so the
        allocator unmaps retention pages — this is what actually lowers
        the process's ``/proc/self/maps`` count after large transient
        buffers are freed.
    """
    for cache in _package_lru_caches():
        cache.cache_clear()
    import jax

    jax.clear_caches()
    gc.collect()
    if trim_malloc:
        try:  # pragma: no cover - absent on non-glibc platforms
            import ctypes

            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except OSError:  # pragma: no cover - non-glibc libc
            pass

"""Multi-process (multi-host) wiring for the corpus engine.

The reference is a single-process tool (SURVEY §2.5: "the reference has
none"); at corpus scale the unit of distribution is the file, mirroring the
reference's decoder-per-file model (``bjxa.3.rst.in:119-120``).  This module
owns the three pieces the library needs to run one corpus job across N
cooperating processes:

* :func:`initialize` — wires ``jax.distributed`` from CLI flags or
  ``BJXA_COORDINATOR``/``BJXA_NUM_PROCESSES``/``BJXA_PROCESS_ID`` env vars
  (each optional).  On CPU backends it selects gloo collectives so
  multi-process runs work on plain hosts — this is how the multi-process
  tests spawn a real 2-process job with a local coordinator; processes
  that share a GPU host under a ``localhost`` coordinator get cards of
  their own (:func:`gpu_local_device_ids`).
* :func:`process_info` — the (index, count) every sharding decision keys
  on, derived from the live JAX runtime (never passed by hand once
  initialized).
* :func:`allreduce_counters` — cross-host reduction of the corpus
  throughput counters (an ``all_gather`` of five int64s; identity
  when single-process).

File I/O stays host-local: each process globs its own filesystem and takes
a round-robin shard of the sorted file list, so nothing crosses the network
but the final metrics reduction.
"""

from __future__ import annotations

import dataclasses
import os

from bjxa_tpu.utils.profiler import Counters


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize ``jax.distributed`` for a multi-process corpus job.

    Arguments fall back to ``BJXA_COORDINATOR`` / ``BJXA_NUM_PROCESSES`` /
    ``BJXA_PROCESS_ID``.  Returns True when the distributed runtime was
    (newly or already) initialized, False for a plain single-process run
    (no arguments given anywhere).

    Raises :class:`ValueError` when the flags are inconsistent (e.g. a
    process id without a process count).
    """
    coordinator = coordinator or os.environ.get("BJXA_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("BJXA_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("BJXA_PROCESS_ID")

    if coordinator is None and num_processes is None and process_id is None:
        return False
    if num_processes is not None and num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if (process_id is None) != (num_processes is None):
        raise ValueError(
            "--process-id and --num-processes must be given together"
        )
    if process_id is not None and not (0 <= process_id < num_processes):
        raise ValueError("process id out of range")

    import jax

    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:  # already wired
        return True

    # CPU backends need an explicit cross-process collectives layer; GPU
    # processes need their own cards.  Deciding off the *configured*
    # platform (not an instantiated backend) keeps this callable before
    # any device use, which jax.distributed.initialize requires anyway.
    platforms = jax.config.jax_platforms or ""
    local_device_ids = None
    if "cpu" in platforms.split(","):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    else:
        local_device_ids = gpu_local_device_ids(
            coordinator, num_processes, process_id, visible_gpus()
        )

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _enable_rank_cache_writes()
    return True


def visible_gpus() -> int:
    """GPUs this process may open, counted without starting a backend:
    ``CUDA_VISIBLE_DEVICES`` when set, else the ``/dev/nvidiaN`` nodes."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return len([d for d in env.split(",") if d.strip()])
    import glob

    return len(glob.glob("/dev/nvidia[0-9]*"))


def gpu_local_device_ids(
    coordinator: str | None,
    num_processes: int | None,
    process_id: int | None,
    n_gpus: int,
) -> list[int] | None:
    """The cards process ``process_id`` owns on its host, or None for
    JAX's default (every visible card).

    A JAX process reserves most of every card it opens, so processes that
    share a host must not share cards.  Only a ``localhost`` coordinator
    says where the processes run: all on this host, where they split its
    cards evenly (more processes than cards is an error).  Any other
    coordinator leaves the per-host layout unknown — the usual multi-host
    job runs one process per host owning all of its cards — so no cards
    are named; processes sharing a host there need a ``localhost``
    coordinator or their own ``CUDA_VISIBLE_DEVICES``.
    """
    if num_processes is None or process_id is None:
        return None
    host = (coordinator or "").rsplit(":", 1)[0]
    if host not in ("localhost", "127.0.0.1", "[::1]", ""):
        return None
    if n_gpus < 1:
        raise ValueError("no GPU visible to this process")
    if num_processes > n_gpus:
        raise ValueError(
            f"{num_processes} processes on one host with {n_gpus} "
            "GPUs: each process needs a card of its own"
        )
    per = n_gpus // num_processes
    return list(range(process_id * per, (process_id + 1) * per))


def _enable_rank_cache_writes() -> None:
    """Let every rank write the persistent compile cache, not just rank 0.

    JAX skips persistent-cache *writes* on ``process_id != 0`` (guarding
    against write contention on shared network filesystems).  Our corpus
    computations are process-local jits whose cache keys embed the rank's
    own device ids, so rank 0 never produces the entries other ranks need
    — without writes, every nonzero rank pays a full compile of every
    shape in every job (measured: a 2-process corpus job ran rank 1 at
    ~5x rank 0's time, reproducibly, because of exactly this).  Cache
    directories here are host-local and writes are atomic (tmp+rename),
    so the contention concern does not apply; keys are rank-specific so
    ranks never collide.  Implemented as a wrapper that presents
    ``process_id == 0`` to the write path only; degrades to a no-op if
    JAX internals move.
    """
    try:
        from jax._src import compiler as _compiler

        orig = _compiler._cache_write
        if getattr(orig, "_bjxa_rank_writes", False):  # pragma: no cover
            return

        def cache_write_all_ranks(*args, **kwargs):
            gs = _compiler.distributed.global_state
            saved = gs.process_id
            gs.process_id = 0
            try:
                return orig(*args, **kwargs)
            finally:
                gs.process_id = saved

        cache_write_all_ranks._bjxa_rank_writes = True
        _compiler._cache_write = cache_write_all_ranks
    except Exception:  # pragma: no cover - future-jax safety net
        pass


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of the live runtime; (0, 1) when JAX
    is uninitialized or single-process."""
    try:
        import jax

        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def _allgather_rows(values):
    """All-gather one int vector per process -> ``int64[n_processes, len]``.

    JAX truncates int64 arrays to int32 unless x64 is enabled globally, so
    values are split into 31-bit halves for the wire and reassembled here —
    corpus byte/sample counters routinely exceed 2**31.
    """
    import numpy as np
    from jax.experimental import multihost_utils

    vec = np.asarray(values, np.int64)
    assert (vec >= 0).all(), "counters are non-negative by construction"
    halves = np.stack([vec >> 31, vec & 0x7FFFFFFF]).astype(np.int32)
    rows = np.asarray(multihost_utils.process_allgather(halves))
    return (rows[:, 0].astype(np.int64) << 31) | rows[:, 1].astype(np.int64)


def allreduce_sum(values) -> list[int]:
    """Element-wise sum of a small non-negative int vector across all
    processes.

    Single-process: returns ``values`` as a list.  Multi-process: a
    collective every process must enter; each receives the global sums.
    """
    import jax

    values = [int(v) for v in values]
    if jax.process_count() == 1:
        return values
    return [int(v) for v in _allgather_rows(values).sum(axis=0)]


def allreduce_counters(counters: Counters) -> Counters:
    """Sum throughput counters across all processes.

    Single-process: returns ``counters`` unchanged.  Multi-process: every
    process must call this (it is a collective); each receives the global
    totals.  Elapsed time is the max across processes (the job is done when
    the slowest host is).
    """
    import jax

    if jax.process_count() == 1:
        return counters

    rows = _allgather_rows(
        [
            counters.files,
            counters.blocks,
            counters.samples,
            counters.bytes_in,
            counters.bytes_out,
            int(counters.elapsed() * 1e9),
        ]
    )
    tot = rows[:, :5].sum(axis=0)
    slowest = float(rows[:, 5].max()) / 1e9
    return Counters(
        files=int(tot[0]),
        blocks=int(tot[1]),
        samples=int(tot[2]),
        bytes_in=int(tot[3]),
        bytes_out=int(tot[4]),
        frozen_s=slowest,
    )

"""Device-sharded decode: data parallel over files, sequence parallel over
the block range of a single stream.

The whole cross-device "context" of an XA stream is two int16 predictor
taps per channel (``bjxa.5.rst:186-187``), so sequence-parallel decode is a
boundary-state fixed point over the device ring: every device decodes its
block range from a guessed input state, sends its exact end state to the
right neighbour with ``lax.ppermute``, and the ring iterates until a
``psum``-agreed fixed point — at most ``n_devices`` rounds, typically 2-3,
each round internally running the intra-device chunk fixed point
(:func:`bjxa_tpu.ops.decode.fixpoint_lanes_core`).  The result is
bit-exact.  All inputs are host-staged lane-major so the device bodies run
zero byte transposes.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from bjxa_tpu.ops.decode import (
    decode_batch,
    decode_batch_lanes,
    decode_words_routed,
)
from bjxa_tpu.ops.tables import BLOCK_SAMPLES


# --------------------------------------------------------------------------
# data parallel over files
# --------------------------------------------------------------------------


def decode_corpus_sharded(
    blocks, states, *, bits: int, mesh: Mesh, axis: str = "dp"
):
    """Decode a batch of equal-shape files sharded over the mesh's file axis.

    Args:
      blocks: ``uint8[N, C, B, block_size]`` with N divisible by the axis
        size (the corpus engine pads with dummy files).
      states: ``int32[N, C, 2]``.

    Idiomatic sharded jit: inputs carry NamedShardings over the file axis
    and XLA partitions the (embarrassingly parallel) lane computation — no
    collectives needed since file lanes never communicate.
    """
    from bjxa_tpu.parallel.mesh import dp_sharding

    n_shard = mesh.shape[axis]
    assert blocks.shape[0] % n_shard == 0
    blocks = jax.device_put(
        jnp.asarray(blocks), dp_sharding(mesh, blocks.ndim, axis)
    )
    states = jax.device_put(
        jnp.asarray(states, jnp.int32), dp_sharding(mesh, 3, axis)
    )
    return decode_batch(blocks, states, bits=bits)


@functools.lru_cache(maxsize=None)
def _corpus_lanes_fn(mesh: Mesh, axis: str, bits: int):
    """Cached jitted shard_map for the lane-sharded corpus decode (a fresh
    wrapper per call would re-trace and re-compile once per batch).
    ``check_vma=False``: the body may hold a pallas_call, whose out_shape
    carries no varying-manifest annotation — and the lane computation is
    embarrassingly parallel, so there is no replication to check."""
    return jax.jit(
        shard_map(
            partial(decode_batch_lanes.__wrapped__, bits=bits),
            mesh=mesh,
            in_specs=(P(None, None, axis), P(axis, None)),
            out_specs=(P(None, None, axis), P(axis, None), P(None, axis)),
            check_vma=False,
        )
    )


def decode_corpus_sharded_lanes(
    blocks_t, states, *, bits: int, mesh: Mesh, axis: str = "dp"
):
    """Lane-sharded corpus decode: the lane axis (files x channels) splits
    over the mesh's data-parallel axis with ``shard_map`` — each device runs
    the fused lane-major pipeline on its own shard, zero communication.

    Args:
      blocks_t: ``uint8[B, S, L]`` lane-major raw blocks (host-staged).
      states:   ``int32[L, 2]``.

    Lanes are padded to the axis size; the pad is trimmed before return.

    Returns ``(pcm int16[B, 32, L], end int32[L, 2], valid bool[B, L])``.
    """
    n_shard = mesh.shape[axis]
    B, S, L = blocks_t.shape
    pad = (-L) % n_shard
    if pad:
        blocks_t = np.concatenate(
            [blocks_t, np.zeros((B, S, pad), np.uint8)], axis=2
        )
        states = np.concatenate(
            [states, np.zeros((pad, 2), np.int32)], axis=0
        )

    fn = _corpus_lanes_fn(mesh, axis, bits)
    pcm, end, valid = fn(
        jnp.asarray(blocks_t), jnp.asarray(states, jnp.int32)
    )
    if pad:
        pcm, end, valid = pcm[:, :, :L], end[:L], valid[:, :L]
    return pcm, end, valid


@functools.lru_cache(maxsize=None)
def _corpus_words_fn(mesh: Mesh, axis: str, bits: int):
    """Cached jitted shard_map for the packed-words lane-sharded corpus
    decode with FLAT per-shard output.

    Each shard decodes its own lane slice through the packed-words path
    on the active kernel route and returns its PCM as a flat int16
    vector, the same host contract as
    :func:`bjxa_tpu.ops.decode.decode_batch_packed`.  Validity and end
    state stay host-side (the host staged the profile bytes).
    ``check_vma=False`` as in :func:`_corpus_lanes_fn`.
    """

    def body(prof, words, states):
        pcm, _end = decode_words_routed(prof, words, states, bits=bits)
        return pcm.reshape(-1)

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(None, axis), P(None, None, axis), P(axis, None)),
            out_specs=P(axis),
            check_vma=False,
        )
    )


def decode_corpus_sharded_words(
    prof, words, states, *, bits: int, mesh: Mesh, axis: str = "dp"
):
    """Packed-words lane-sharded corpus decode with flat D2H results.

    The mesh twin of :func:`bjxa_tpu.ops.decode.decode_batch_packed`: the
    lane axis (files x channels) shards over the mesh's data-parallel
    axis, each device runs the words path on its shard, and the PCM
    comes back as ONE flat int16 vector per shard.

    Args:
      prof:   ``uint8[B, L]`` profile bytes (host-staged).
      words:  ``int32[B, bits, L]`` packed payload words.
      states: ``int32[L, 2]``.

    Returns ``(pcm_flat, reassemble)`` where ``pcm_flat`` is the
    not-yet-transferred device result (callers may start async readback)
    and ``reassemble(np.asarray(pcm_flat)) -> int16[B, 32, L]`` undoes the
    shard-major flat layout host-side (one numpy copy).
    """
    n_shard = mesh.shape[axis]
    B, L = prof.shape
    pad = (-L) % n_shard
    if pad:
        prof = np.concatenate(
            [prof, np.zeros((B, pad), np.uint8)], axis=1
        )
        words = np.concatenate(
            [words, np.zeros((B, words.shape[1], pad), words.dtype)], axis=2
        )
        states = np.concatenate(
            [states, np.zeros((pad, 2), np.int32)], axis=0
        )
    Lp = L + pad
    fn = _corpus_words_fn(mesh, axis, bits)
    pcm_flat = fn(
        jnp.asarray(prof),
        jnp.asarray(words, jnp.int32),
        jnp.asarray(states, jnp.int32),
    )

    def reassemble(flat: np.ndarray) -> np.ndarray:
        return (
            flat.reshape(n_shard, B, BLOCK_SAMPLES, Lp // n_shard)
            .transpose(1, 2, 0, 3)
            .reshape(B, BLOCK_SAMPLES, Lp)[:, :, :L]
        )

    return pcm_flat, reassemble


@functools.lru_cache(maxsize=None)
def _corpus_encode_fn(mesh: Mesh, axis: str, bits: int, search: bool,
                      flat: bool = False):
    """Cached jitted shard_map for the lane-sharded corpus encode.

    ``check_vma=False`` for the same reason as :func:`_corpus_lanes_fn`:
    the search body may hold a pallas_call and lanes never communicate.
    With ``flat`` each shard returns its packed blocks as a flat uint8
    vector.
    """
    from bjxa_tpu.ops.deflate import deflate_blocks
    from bjxa_tpu.ops.encode import encode_search, encode_truncate

    def body(pcm, states):
        if search:
            profiles, coded, _recon, _end = encode_search(
                pcm, states, bits=bits
            )
        else:
            profiles, coded = encode_truncate(pcm)
        # [B, 32, L] -> [B, L, 32] so packed bytes land channel-major
        # within each effective block (the file layout).
        blocks = deflate_blocks(profiles, coded.transpose(0, 2, 1), bits)
        return blocks.reshape(-1) if flat else blocks

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(None, None, axis), P(axis, None)),
            out_specs=P(axis) if flat else P(None, axis, None),
            check_vma=False,
        )
    )


def encode_corpus_sharded_lanes(
    pcm_lanes, states, *, bits: int, search: bool, mesh: Mesh,
    axis: str = "dp"
):
    """Lane-sharded corpus encode: files x channels lanes split over the
    mesh's data-parallel axis; each device runs the 80-profile search (or
    truncation) plus bit-pack on its own lanes, zero communication —
    the encode mirror of :func:`decode_corpus_sharded_lanes`.

    Args:
      pcm_lanes: int-like ``[B, 32, L]`` lane-major samples (zero-padded
        final block), host-staged.
      states:    ``int32[L, 2]`` initial predictor state per lane.

    Lanes are padded to the axis size; the pad is trimmed before return.

    Returns raw XA blocks ``uint8[B, L, block_size]``.
    """
    n_shard = mesh.shape[axis]
    B, ns, L = pcm_lanes.shape
    pad = (-L) % n_shard
    if pad:
        pcm_lanes = np.concatenate(
            [pcm_lanes, np.zeros((B, ns, pad), pcm_lanes.dtype)], axis=2
        )
        states = np.concatenate(
            [states, np.zeros((pad, 2), np.int32)], axis=0
        )
    fn = _corpus_encode_fn(mesh, axis, bits, search)
    blocks = fn(
        jnp.asarray(pcm_lanes, jnp.int32), jnp.asarray(states, jnp.int32)
    )
    if pad:
        blocks = blocks[:, :L]
    return blocks


def encode_corpus_sharded_flat(
    pcm_lanes, states, *, bits: int, search: bool, mesh: Mesh,
    axis: str = "dp"
):
    """Lane-sharded corpus encode with flat per-shard D2H results.

    Same computation as :func:`encode_corpus_sharded_lanes`, but each
    shard's packed blocks come back as a flat uint8 vector.  Returns ``(blocks_flat, reassemble)``
    where ``reassemble(np.asarray(blocks_flat)) ->
    uint8[B, L, block_size]`` undoes the shard-major layout host-side.
    """
    n_shard = mesh.shape[axis]
    B, ns, L = pcm_lanes.shape
    S = bits * 4 + 1
    pad = (-L) % n_shard
    if pad:
        pcm_lanes = np.concatenate(
            [pcm_lanes, np.zeros((B, ns, pad), pcm_lanes.dtype)], axis=2
        )
        states = np.concatenate(
            [states, np.zeros((pad, 2), np.int32)], axis=0
        )
    Lp = L + pad
    fn = _corpus_encode_fn(mesh, axis, bits, search, flat=True)
    blocks_flat = fn(
        jnp.asarray(pcm_lanes, jnp.int32), jnp.asarray(states, jnp.int32)
    )

    def reassemble(flat: np.ndarray) -> np.ndarray:
        return (
            flat.reshape(n_shard, B, Lp // n_shard, S)
            .transpose(1, 0, 2, 3)
            .reshape(B, Lp, S)[:, :L]
        )

    return blocks_flat, reassemble


# --------------------------------------------------------------------------
# sequence parallel over one stream's block range
# --------------------------------------------------------------------------


def decode_file_sharded(
    blocks: np.ndarray,
    state: np.ndarray,
    *,
    bits: int,
    mesh: Mesh,
    axis: str = "sp",
    local_chunks: int = 16,
):
    """Decode one stream with its block range sharded across devices.

    Args:
      blocks: ``uint8[C, B, block_size]``; B is padded up to the device x
        chunk grid with valid dummy blocks.
      state:  ``int32[C, 2]`` initial predictor state from the header.
      local_chunks: intra-device chunk-parallel lanes per ring round.

    Returns ``(pcm int16[B*32, C], valid bool[B, C], rounds int32)``.
    """
    n = mesh.shape[axis]
    C, B, S = blocks.shape
    K = local_chunks
    grid = n * K
    Bp = -(-B // grid) * grid
    if Bp != B:
        pad = np.zeros((C, Bp - B, S), np.uint8)
        blocks = np.concatenate([blocks, pad], axis=1)

    # Host-stage the per-device chunk-lane layout (uint8[n, Bc, S, K*C],
    # lane l = k*C + c) so no device byte transposes run inside the body.
    Bc = Bp // grid
    blocks_lm = np.ascontiguousarray(
        blocks.reshape(C, n, K, Bc, S).transpose(1, 3, 4, 2, 0)
    ).reshape(n, Bc, S, K * C)

    fn = _file_sharded_fn(mesh, axis, bits, K, C)
    pcm, valid, rounds = fn(
        jnp.asarray(blocks_lm), jnp.asarray(state, jnp.int32)
    )
    return (
        np.asarray(pcm)[: B * BLOCK_SAMPLES],
        np.asarray(valid)[:B],
        int(np.asarray(rounds).reshape(-1)[0]),
    )


@functools.lru_cache(maxsize=None)
def _file_sharded_fn(mesh: Mesh, axis: str, bits: int, local_chunks: int,
                     channels: int):
    """Cached jitted shard_map for the sequence-parallel ring decoder (a
    fresh wrapper per call would re-trace once per call — segmented
    huge-file decode calls this once per segment)."""
    return jax.jit(
        shard_map(
            partial(
                _sharded_body,
                bits=bits,
                axis=axis,
                local_chunks=local_chunks,
                channels=channels,
            ),
            mesh=mesh,
            in_specs=(P(axis, None, None, None), P(None, None)),
            out_specs=(P(axis, None), P(axis, None), P(axis)),
            check_vma=False,  # body holds a pallas_call (no vma out_shape)
        ),
    )


def encode_file_sharded(
    pcm: np.ndarray,
    state: np.ndarray,
    *,
    bits: int,
    mesh: Mesh,
    axis: str = "sp",
    local_chunks: int = 16,
    b_total: int | None = None,
):
    """Search-encode one stream with its block range sharded across devices.

    The encode mirror of :func:`decode_file_sharded`: the greedy
    80-profile search's only cross-block coupling is the 2-tap carried
    state (identical to the decoder's), so the same ppermute ring
    boundary fixed point applies — every device search-encodes its block
    range from a guessed entry state (running the intra-device chunk
    fixed point of :func:`bjxa_tpu.ops.encode.encode_search_fixpoint`
    device-side), sends its exact end state one device forward, and the
    ring iterates to a ``psum``-agreed fixed point.  Bit-identical to the
    sequential greedy search; a huge WAV encode uses all chips the way
    the same file's decode does (reference anchor for the mirrored
    streaming-encode capability: ``src/bjxa_encode.c:108-160``).

    Args:
      pcm: int-like ``[B, 32, C]`` block-major samples (zero-padded final
        block); B is padded up to the device x chunk grid with zero
        blocks.
      state: ``int32[C, 2]`` entry predictor/search state.
      b_total: real block count if ``pcm`` already carries bucket pad
        (outputs are trimmed to it and the end state is read after block
        ``b_total - 1``); defaults to B.

    Returns ``(blocks uint8[b_total, C, block_size], end int32[C, 2],
    rounds int32)`` — packed XA blocks in file order, the exact carried
    state after the last real block, and the ring-round count.
    """
    n = mesh.shape[axis]
    B, ns, C = pcm.shape
    if b_total is None:
        b_total = B
    K = local_chunks
    grid = n * K
    Bp = -(-B // grid) * grid
    arr = np.asarray(pcm, np.int32)
    if Bp != B:
        arr = np.concatenate(
            [arr, np.zeros((Bp - B, ns, C), np.int32)], axis=0
        )

    # Host-stage the per-device chunk-lane layout (int32[n, Bc, 32, K*C],
    # lane l = k*C + c), mirroring decode_file_sharded's staging.
    Bc = Bp // grid
    pcm_lm = np.ascontiguousarray(
        arr.reshape(n, K, Bc, ns, C).transpose(0, 2, 3, 1, 4)
    ).reshape(n, Bc, ns, K * C)

    fn = _file_sharded_encode_fn(mesh, axis, bits, K, C)
    blocks, last_rec, rounds = fn(
        jnp.asarray(pcm_lm),
        jnp.asarray(state, jnp.int32),
        jnp.int32(b_total - 1),
    )
    lr = np.asarray(last_rec)  # [32, C] recon of the last real block
    end = np.stack([lr[-1], lr[-2]], axis=-1).astype(np.int32)
    return (
        np.asarray(blocks)[:b_total],
        end,
        int(np.asarray(rounds).reshape(-1)[0]),
    )


@functools.lru_cache(maxsize=None)
def _file_sharded_encode_fn(mesh: Mesh, axis: str, bits: int,
                            local_chunks: int, channels: int):
    """Cached jitted shard_map for the sequence-parallel ring encoder
    (segmented huge-file encode calls this once per segment)."""
    return jax.jit(
        shard_map(
            partial(
                _sharded_encode_body,
                bits=bits,
                axis=axis,
                local_chunks=local_chunks,
                channels=channels,
            ),
            mesh=mesh,
            in_specs=(P(axis, None, None, None), P(None, None), P()),
            out_specs=(P(axis, None, None), P(None, None), P(axis)),
            check_vma=False,  # body holds a pallas_call (no vma out_shape)
        ),
    )


def _sharded_encode_body(pcm_lm, state0, q_last, *, bits, axis,
                         local_chunks, channels):
    """Per-device body: local chunk-fixpoint search encode + ring boundary
    fixed point, then on-device bit-pack.  ``q_last`` is the (dynamic)
    global index of the last real block; its reconstruction is extracted
    with a masked ``psum`` so the host recovers the exact carried state
    without shipping the full reconstruction back."""
    from bjxa_tpu.ops.decode import _fixpoint_states
    from bjxa_tpu.ops.deflate import deflate_blocks
    from bjxa_tpu.ops.encode import encode_search

    pcm_t = pcm_lm[0]  # [Bc, 32, K*C] — this device's chunk lanes
    Bc, ns, KC = pcm_t.shape
    K, C = local_chunks, channels
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)

    def run(states_flat, with_output):
        profiles, coded, recon, end = encode_search(
            pcm_t, states_flat, bits=bits
        )
        return (profiles, coded, recon), end

    def local_end(my_state):
        """Exact end state of this device's block range given its entry."""
        states, _ = _fixpoint_states(run, my_state, K, C, max_iters=K)
        _, end = run(states.reshape(K * C, 2), False)
        return end.reshape(K, C, 2)[-1]

    fwd = [(i, (i + 1) % n) for i in range(n)]

    def propagate(my_state):
        nxt = lax.ppermute(local_end(my_state), axis, perm=fwd)
        return jnp.where(idx == 0, state0, nxt)

    def changed_somewhere(a, b):
        local = jnp.any(a != b).astype(jnp.int32)
        return lax.psum(local, axis) > 0

    def cond(carry):
        st, prev, it = carry
        return jnp.logical_and(it < n, changed_somewhere(st, prev))

    def body(carry):
        st, _, it = carry
        return propagate(st), st, it + 1

    init = jnp.where(idx == 0, state0, jnp.zeros_like(state0))
    first = propagate(init)
    st, _, rounds = lax.while_loop(cond, body, (first, init, jnp.int32(1)))

    # Final full pass from the converged (exact) device entry state.
    states, _ = _fixpoint_states(run, st, K, C, max_iters=K)
    (profiles, coded, recon), _end = run(states.reshape(K * C, 2), True)

    # Unscramble chunk lanes to this device's block order and pack.
    prof_d = profiles.reshape(Bc, K, C).transpose(1, 0, 2).reshape(K * Bc, C)
    coded_d = (
        coded.reshape(Bc, ns, K, C).transpose(2, 0, 3, 1)
        .reshape(K * Bc, C, ns)
    )
    blocks = deflate_blocks(prof_d, coded_d, bits)  # uint8[K*Bc, C, S]

    # Recon of the (dynamic) last real block, owner-masked + psum.
    my_base = idx * K * Bc
    rel = jnp.clip(q_last - my_base, 0, K * Bc - 1)
    k_idx = rel // Bc
    b_idx = rel % Bc
    sel = lax.dynamic_slice(
        recon, (b_idx, jnp.int32(0), k_idx * C), (1, ns, C)
    )[0].astype(jnp.int32)
    owns = jnp.logical_and(q_last >= my_base, q_last < my_base + K * Bc)
    last_rec = lax.psum(jnp.where(owns, sel, 0), axis)

    return blocks, last_rec, rounds[None]


def _sharded_body(blocks_lm, state0, *, bits, axis, local_chunks, channels):
    """Per-device body: local fixpoint decode + ring boundary fixed point."""
    from bjxa_tpu.ops.decode import (
        fixpoint_lanes_core,
        fixpoint_lanes_end_state,
    )

    blocks_t = blocks_lm[0]  # [Bc, S, K*C] — this device's chunk lanes
    Bc = blocks_t.shape[0]
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)

    fwd = [(i, (i + 1) % n) for i in range(n)]

    def propagate(my_state):
        end = fixpoint_lanes_end_state(
            blocks_t, my_state, local_chunks, channels, bits=bits
        )
        nxt = lax.ppermute(end, axis, perm=fwd)
        return jnp.where(idx == 0, state0, nxt)

    def changed_somewhere(a, b):
        local = jnp.any(a != b).astype(jnp.int32)
        return lax.psum(local, axis) > 0

    def cond(carry):
        st, prev, it = carry
        return jnp.logical_and(it < n, changed_somewhere(st, prev))

    def body(carry):
        st, _, it = carry
        return propagate(st), st, it + 1

    init = jnp.where(idx == 0, state0, jnp.zeros_like(state0))
    first = propagate(init)
    st, _, rounds = lax.while_loop(cond, body, (first, init, jnp.int32(1)))

    pcm, _end, valid, _iters = fixpoint_lanes_core(
        blocks_t, st, local_chunks, channels, local_chunks * Bc, bits=bits
    )
    return pcm, valid, rounds[None]

"""Jitted XA encode pipelines.

Two encoders:

* :func:`encode_truncate` — byte-compatible with the reference encoder,
  which performs *no* prediction: profile byte 0, keep the top ``bits`` of
  every sample (``src/libbjxa.c:665-691``, "Encoding is partially
  implemented", ``bjxa.1.rst:55``).
* :func:`encode_search` — what the reference leaves on the table: a greedy
  per-block exhaustive sweep of all 80 filter profiles (5 factors x 16
  ranges), each candidate running the *real* decoder recurrence
  (prediction, truncating division, int16 saturation) so carried state is
  exact; the minimum-reconstruction-error candidate wins.  Blocks stay
  sequential (state feedback), but the 80 candidates, the channels and any
  number of batched lanes evaluate in parallel — the encoder
  analog of the decoder's lane vectorization (SURVEY §2.5).

Quantization for a candidate with range ``r``: the decoder computes
``clamp(d >> r + pred)`` where ``d`` holds ``bits`` significant top bits,
``d = q << (16-bits)``.  The best ``q`` for target difference ``diff`` is
``round(diff / 2^(16-bits-r))`` (or ``diff << (r-16+bits)`` when the range
exceeds the quantization headroom), clamped to the signed ``bits``-bit
domain.

Candidate errors are float32 sums of exact integer squares
(:func:`bjxa_tpu.ops.pallas_encode.square_f32`), so no backend can fuse
the multiply into the add and move a near-tie.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from bjxa_tpu.ops.filter import kernel_route, trunc_div_256
from bjxa_tpu.ops.pallas_encode import square_f32
from bjxa_tpu.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
    NUM_FACTORS,
    NUM_RANGES,
)

NUM_CANDIDATES = NUM_FACTORS * NUM_RANGES  # 80


def _candidate_tables():
    """Static per-candidate tables: factor, range, gains, shift splits."""
    factor = np.repeat(np.arange(NUM_FACTORS), NUM_RANGES)
    rng = np.tile(np.arange(NUM_RANGES), NUM_FACTORS)
    return factor, rng


def encode_truncate(pcm: jnp.ndarray):
    """Reference-compatible encode: profile 0, samples passed through.

    ``pcm``: int-like ``[B, 32, L]`` (zero-padded final block).
    Returns ``(profiles int32[B, L], coded int32[B, 32, L])`` where
    ``coded`` feeds :func:`bjxa_tpu.ops.deflate.pack_payload` (which keeps
    the top bits, exactly like the reference's deflate callbacks).
    """
    profiles = jnp.zeros(pcm.shape[::2], jnp.int32)
    return profiles, pcm.astype(jnp.int32)


def encode_search(pcm: jnp.ndarray, state: jnp.ndarray, *, bits: int):
    """Greedy exhaustive profile-search encode (dispatcher).

    On the ``triton`` route the Pallas search kernel runs
    (:mod:`bjxa_tpu.ops.pallas_encode`); on the ``xla`` route the
    lane-vectorized scan below.  Both pick identical profiles (same
    candidate order, same float32 error accumulation); see
    :func:`encode_search_scan` for args/returns.
    """
    if kernel_route() == "triton":
        from bjxa_tpu.ops.pallas_encode import encode_search_triton

        return encode_search_triton(pcm, state, bits=bits)
    return encode_search_scan(pcm, state, bits=bits)


@partial(jax.jit, static_argnames=("bits", "search"))
def encode_batch_blocks(pcm: jnp.ndarray, *, bits: int, search: bool):
    """One-dispatch corpus encode: PCM lanes -> packed XA blocks.

    Fuses profile search (or truncation) and bit-packing into a single
    compiled program so a corpus batch costs one dispatch and one
    device->host transfer; the all-zero initial predictor state (XA
    headers emitted by the encoder carry zero seeds) is synthesized
    on device instead of shipped from the host.

    Args:
      pcm: int-like ``[B, 32, L]`` lane-major samples (zero-padded final
        block).

    Returns raw XA blocks as a FLAT uint8 vector (host layout
    ``[B, L, block_size]``, channel-major within each effective block —
    the file layout); hosts recover the layout with a free reshape.
    """
    from bjxa_tpu.ops.deflate import deflate_blocks

    state = jnp.zeros((pcm.shape[-1], 2), jnp.int32)
    if search:
        profiles, coded, _recon, _end = encode_search(pcm, state, bits=bits)
    else:
        profiles, coded = encode_truncate(pcm)
    return deflate_blocks(profiles, coded.transpose(0, 2, 1), bits).reshape(-1)


def encode_search_fixpoint(
    pcm: np.ndarray,
    state: np.ndarray,
    *,
    bits: int,
    num_chunks: int,
):
    """Chunk-parallel exact profile-search encode of ONE stream.

    The greedy search's only cross-block coupling is the 2-tap carried
    state, exactly like the decoder — so the decoder's boundary-state
    fixed point applies: split the block range into ``num_chunks``
    chunks laid out as independent lanes, encode all chunks in parallel
    from guessed entry states, propagate each chunk's exact end state
    one chunk forward, and iterate until nothing changes.  Chunk 0 is
    anchored at the true entry state, so after r rounds chunks 0..r are
    exactly right; the fixed point IS the sequential encode (bitwise),
    and it is reached in 2-6 rounds regardless of K on every measured
    signal regime (``tools/encode_fixpoint_census.py``).  This lifts a
    single stream's search from a B-row serial kernel to
    ``rounds x (B/K)``-row kernels over ``K * channels`` lanes (see
    :func:`pick_encode_chunks` for when it is on).

    Args:
      pcm:   int-like ``[B, 32, C]`` (zero-padded final block).
      state: ``int32[C, 2]`` entry state.

    Returns ``(profiles int32[B, C], coded int32[B, 32, C],
    recon int16[B, 32, C], end_state int32[C, 2], rounds int)``.
    """
    import jax.numpy as jnp

    B, ns, C = pcm.shape
    K = num_chunks
    Bc = -(-B // K)
    pad = K * Bc - B
    arr = np.asarray(pcm, np.int32)
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad, ns, C), np.int32)], axis=0
        )
    # lanes l = k*C + c (chunk-major, channel-minor), like the decoder
    lanes = np.ascontiguousarray(
        arr.reshape(K, Bc, ns, C).transpose(1, 2, 0, 3)
    ).reshape(Bc, ns, K * C)
    lanes_j = jnp.asarray(lanes)

    states = np.zeros((K, C, 2), np.int32)
    states[0] = np.asarray(state, np.int32)
    rounds = 0
    prof = coded = recon = end = None
    while rounds < K:
        prof, coded, recon, end = encode_search(
            lanes_j, jnp.asarray(states.reshape(K * C, 2)), bits=bits
        )
        e = np.asarray(end).reshape(K, C, 2)
        new_states = np.concatenate([states[:1], e[:-1]], axis=0)
        rounds += 1
        if (new_states == states).all():
            break
        states = new_states

    # unscramble chunk lanes back to stream order and trim the pad
    prof_s = (
        np.asarray(prof).reshape(Bc, K, C).transpose(1, 0, 2)
        .reshape(K * Bc, C)[:B]
    )
    coded_s = (
        np.asarray(coded).reshape(Bc, ns, K, C).transpose(2, 0, 1, 3)
        .reshape(K * Bc, ns, C)[:B]
    )
    recon_s = (
        np.asarray(recon).reshape(Bc, ns, K, C).transpose(2, 0, 1, 3)
        .reshape(K * Bc, ns, C)[:B]
    )
    # true end state: after the last REAL block (pad blocks, if any, all
    # live in the final chunk and are trimmed; their lanes' end states
    # are garbage, so recover from the reconstruction)
    end_s = np.stack(
        [recon_s[B - 1, -1, :], recon_s[B - 1, -2, :]], axis=-1
    ).astype(np.int32)
    return prof_s, coded_s, recon_s, end_s, rounds


#: Whether the encode chunk fixpoint is on by default, per kernel route.
#: ``xla``: off — the CPU backend is element-throughput-bound at any lane
#: width, so the fixpoint's extra rounds are pure extra work.  ``triton``:
#: set from the sequential-vs-fixpoint timing of one long stereo file on
#: the H100 (``chip_smoke.py``, phase ``encode``).
FIXPOINT_DEFAULT = {"triton": True, "xla": False}


def pick_encode_chunks(nblocks: int, channels: int) -> int:
    """Chunk count for :func:`encode_search_fixpoint`.

    Each fixpoint round pays a dispatch plus an end-state device-to-host
    sync, so whether the 2-6 rounds of ``(B/K)``-row kernels beat one
    ``B``-row kernel is a property of the backend; the default follows
    :data:`FIXPOINT_DEFAULT` for the active kernel route.

    ``BJXA_ENCODE_FIXPOINT_CHUNKS`` overrides: ``0``/``off`` forces
    sequential, ``auto`` forces the lane sweet spot, an integer forces K.
    """
    import os

    env = os.environ.get("BJXA_ENCODE_FIXPOINT_CHUNKS", "")
    if env in ("0", "off"):
        return 1
    if nblocks < 64:
        return 1
    if env == "":
        if not FIXPOINT_DEFAULT[kernel_route()]:
            return 1
        env = "auto"
    if env == "auto":
        return max(min(8192 // channels, nblocks // 16), 1)
    try:
        k = int(env)
    except ValueError:
        from bjxa_tpu.errors import BjxaInvalidState

        raise BjxaInvalidState(
            f"Invalid BJXA_ENCODE_FIXPOINT_CHUNKS {env!r}"
        )
    return max(min(k, nblocks // 16), 1)


def iter_encode_segments(
    read,
    channels: int,
    samples: int,
    *,
    bits: int,
    search: bool,
    segment_blocks: int | None = None,
    mesh=None,
    sp_axis: str = "sp",
):
    """Bounded-memory device encode: stream PCM through the device in
    fixed-size block segments, carrying the exact predictor/search state
    between segments.

    The profile search is greedy per block, so segmenting cannot change
    any choice: segment k+1 starts from the exact carried end state
    (``encode_search``'s ``end_state``) and the emitted bytes are
    bit-identical to the one-shot encoder at O(segment) peak memory —
    the encode mirror of :func:`bjxa_tpu.ops.decode.iter_decode_segments`
    (reference anchor: the streaming encode loop
    ``src/bjxa_encode.c:108-160`` with O(block) memory).

    Args:
      read: ``read(nbytes) -> bytes`` pulling little-endian int16
        interleaved PCM (a short result means the stream is truncated).
      samples: frames per channel the container header promises.

    With a multi-device ``mesh`` carrying an ``sp_axis`` of size > 1 and
    ``search`` on, every segment's block range is sequence-parallel
    sharded across the mesh devices through the ppermute boundary-state
    ring (:func:`bjxa_tpu.parallel.sharded.encode_file_sharded`) — the
    pod-scale path for huge WAV encodes: O(segment) host memory AND all
    chips searching, still bit-identical to the sequential greedy search.

    Yields packed XA block bytes per segment.  On a truncated stream,
    yields the whole blocks that arrived (matching the streaming
    encoder's behavior), then raises :class:`EOFError`.
    """
    from bjxa_tpu.ops.decode import SEGMENT_BLOCKS, pad_bucket
    from bjxa_tpu.ops.deflate import deflate_blocks

    if segment_blocks is None:
        segment_blocks = SEGMENT_BLOCKS
    use_mesh = (
        search
        and mesh is not None
        and sp_axis in getattr(mesh, "shape", {})
        and mesh.shape[sp_axis] > 1
    )
    frame_bytes = 2 * channels
    state = jnp.zeros((channels, 2), jnp.int32)
    left = samples
    while left > 0:
        want_frames = min(segment_blocks * BLOCK_SAMPLES, left)
        body = read(want_frames * frame_bytes) or b""
        got = len(body) // frame_bytes
        truncated = got < want_frames
        if truncated:
            nblocks = got // BLOCK_SAMPLES  # whole blocks only mid-stream
            frames_used = nblocks * BLOCK_SAMPLES
        else:
            nblocks = -(-want_frames // BLOCK_SAMPLES)
            frames_used = want_frames
        if nblocks:
            # full segments share one compiled shape; the tail buckets
            Bp = min(segment_blocks, pad_bucket(nblocks))
            arr = np.zeros((Bp * BLOCK_SAMPLES, channels), np.int32)
            arr[:frames_used] = (
                np.frombuffer(body, "<i2", count=frames_used * channels)
                .reshape(-1, channels)
            )
            lanes = arr.reshape(Bp, BLOCK_SAMPLES, channels)
            if use_mesh:
                # sequence-parallel ring encode of this segment's block
                # range (bit-identical; exact carried state from the
                # last real block's reconstruction)
                from bjxa_tpu.parallel.sharded import encode_file_sharded

                blocks_sp, end_sp, _rounds = encode_file_sharded(
                    lanes,
                    np.asarray(state, np.int32),
                    bits=bits,
                    mesh=mesh,
                    axis=sp_axis,
                    b_total=nblocks,
                )
                yield blocks_sp.tobytes()
                state = jnp.asarray(end_sp)
                if truncated:
                    raise EOFError("truncated PCM stream")
                left -= want_frames
                continue
            Kc = pick_encode_chunks(Bp, channels) if search else 1
            if search and Kc > 1:
                # chunk-parallel exact fixed point per segment: the
                # segment's search runs at Kc*channels lanes instead of
                # `channels` (bit-identical; 2-4 rounds)
                profiles, coded, recon_np, _end, _r = (
                    encode_search_fixpoint(
                        lanes,
                        np.asarray(state),
                        bits=bits,
                        num_chunks=Kc,
                    )
                )
                blocks = deflate_blocks(
                    jnp.asarray(profiles),
                    jnp.asarray(coded).transpose(0, 2, 1),
                    bits,
                )
                yield np.asarray(blocks[:nblocks]).tobytes()
                # carried state = after the last REAL block of this
                # segment (robust to the bucket pad either way)
                state = jnp.asarray(
                    np.stack(
                        [
                            recon_np[nblocks - 1, -1, :],
                            recon_np[nblocks - 1, -2, :],
                        ],
                        axis=-1,
                    ).astype(np.int32)
                )
                if truncated:
                    raise EOFError("truncated PCM stream")
                left -= want_frames
                continue
            if search:
                profiles, coded, _recon, end = encode_search(
                    jnp.asarray(lanes), state, bits=bits
                )
            else:
                profiles, coded = encode_truncate(jnp.asarray(lanes))
                end = state
            blocks = deflate_blocks(
                profiles, coded.transpose(0, 2, 1), bits
            )
            yield np.asarray(blocks[:nblocks]).tobytes()
            if Bp == nblocks:
                state = end  # exact (pad blocks would corrupt it, but a
                # padded segment is always the last one emitted)
        if truncated:
            raise EOFError("truncated PCM stream")
        left -= want_frames


@partial(jax.jit, static_argnames=("bits",))
def encode_search_scan(pcm: jnp.ndarray, state: jnp.ndarray, *, bits: int):
    """Greedy exhaustive profile-search encode.

    Args:
      pcm:   ``int32[B, 32, L]`` target samples (zero-padded final block).
      state: ``int32[L, 2]`` initial predictor state (zeros for a fresh
        stream, since the emitted header carries zero seeds).

    Returns ``(profiles int32[B, L], coded int32[B, 32, L],
    recon int16[B, 32, L], end_state int32[L, 2])``; ``recon`` is the exact
    signal a conforming decoder will produce.
    """
    B, _, L = pcm.shape
    shq = 16 - bits
    factor_np, range_np = _candidate_tables()
    k0 = jnp.asarray(GAIN_K0[factor_np], jnp.int32)[:, None]  # [80,1]
    k1 = jnp.asarray(GAIN_K1[factor_np], jnp.int32)[:, None]
    rr = jnp.asarray(range_np, jnp.int32)[:, None]
    s_down = jnp.maximum(shq - rr, 0)  # quantize: arithmetic shift down
    s_up = jnp.maximum(rr - shq, 0)  # or scale up when range > headroom
    bias = (jnp.int32(1) << s_down) >> 1
    use_down = rr <= shq
    qmin = -(1 << (bits - 1))
    qmax = (1 << (bits - 1)) - 1
    prof_cand = jnp.asarray(
        (factor_np << 4) | range_np, jnp.int32
    )  # [80]

    def step(carry, x_blk):  # x_blk: int32[32, L]
        p0, p1 = carry  # [L]
        p0c = jnp.broadcast_to(p0, (NUM_CANDIDATES, L))
        p1c = jnp.broadcast_to(p1, (NUM_CANDIDATES, L))
        err = jnp.zeros((NUM_CANDIDATES, L), jnp.float32)
        ds = []
        recs = []
        for n in range(BLOCK_SAMPLES):
            pred = trunc_div_256(p0c * k0 + p1c * k1)
            diff = x_blk[n][None, :] - pred
            q = jnp.where(use_down, (diff + bias) >> s_down, diff << s_up)
            q = jnp.clip(q, qmin, qmax)
            d = q << shq
            recon = jnp.clip((d >> rr) + pred, INT16_MIN, INT16_MAX)
            err = err + square_f32(x_blk[n][None, :] - recon)
            ds.append(d)
            recs.append(recon)
            p1c = p0c
            p0c = recon
        best = jnp.argmin(err, axis=0)  # [L]
        d_all = jnp.stack(ds)  # [32, 80, L]
        r_all = jnp.stack(recs)
        lane = jnp.arange(L)
        d_sel = d_all[:, best, lane]  # [32, L]
        r_sel = r_all[:, best, lane]
        new_p0 = p0c[best, lane]
        new_p1 = p1c[best, lane]
        return (new_p0, new_p1), (prof_cand[best], d_sel, r_sel)

    init = (state[:, 0], state[:, 1])
    (p0, p1), (profiles, coded, recon) = lax.scan(step, init, pcm)
    end_state = jnp.stack([p0, p1], axis=-1)
    return profiles, coded, recon.astype(jnp.int16), end_state

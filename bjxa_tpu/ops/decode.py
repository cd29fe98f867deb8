"""Jitted XA decode pipelines.

Three device pipelines over one lane-major decode step
(:func:`lanes_decoder`): the fused Pallas kernel on the GPU
(:mod:`bjxa_tpu.ops.pallas_decode`), the XLA lane scan on the CPU
(:mod:`bjxa_tpu.ops.filter`), as :func:`bjxa_tpu.ops.filter.kernel_route`
picks:

* :func:`decode_arrays` — one file, lanes = channels.  The honest
  sequential-over-blocks decode; correctness baseline.
* :func:`decode_arrays_fixpoint` — one file, lanes = channels x chunks.
  Exact intra-file parallelism: the block range is split into K chunks that
  all decode in parallel from guessed boundary predictor states, iterated to
  a fixed point.  Because chunk 0 is anchored at the true header state and
  each iteration propagates exact end states one chunk forward, the fixed
  point is reached in at most K iterations and is *bit-exact*; typical audio
  converges in 2-4 iterations because the filter poles lie inside the unit
  circle (SURVEY §2.5, §7 "hard parts").
* :func:`decode_batch` — many equal-shape channel streams, lanes = N x C.
  The corpus/throughput path.

Hosts call the ``decode_bytes`` convenience which picks a pipeline, checks
profile validity (EPROTO taxonomy) and trims the padded tail.

Reference semantic anchors: block loop ``src/libbjxa.c:602-661``; stereo
blocks are channel-major within an effective block and PCM is interleaved at
stride ``channels``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from bjxa_tpu.errors import BjxaProtocolError
from bjxa_tpu.format.xa import XAFormat
from bjxa_tpu.ops.filter import decode_lanes, kernel_route
from bjxa_tpu.ops.inflate import inflate_lanes
from bjxa_tpu.ops.tables import BLOCK_SAMPLES


# --------------------------------------------------------------------------
# the one lane-major decode step, on the active kernel route
# --------------------------------------------------------------------------


def lanes_decoder(blocks_t: jnp.ndarray, bits: int):
    """Build ``run(states int32[L, 2], with_output) -> (pcm | None, end)``
    over lane-major raw blocks ``uint8[B, S, L]``.

    On the ``triton`` route the blocks are packed into payload words once
    and every run is one fused-kernel launch
    (:func:`bjxa_tpu.ops.pallas_decode.decode_words`); on the ``xla``
    route they are unpacked once and every run is the lane scan.  ``pcm``
    is ``int16[B, 32, L]``.
    """
    if kernel_route() == "triton":
        from bjxa_tpu.ops.pallas_decode import decode_words

        prof, words = pack_words_from_lanes(blocks_t, bits=bits)

        def run(states, with_output):
            return decode_words(
                prof, words, states, bits=bits, with_output=with_output
            )

        return run
    profiles, samples = inflate_lanes(blocks_t, bits)

    def run(states, with_output):
        pcm, end, _valid = decode_lanes(
            profiles, samples, states, with_output=with_output
        )
        return pcm, end

    return run


def decode_words_routed(prof, words, state, *, bits: int):
    """Decode the packed-words layout on the active kernel route.

    ``prof uint8[B, L]``, ``words int32[B, bits, L]``, ``state int32[L,
    2]`` -> ``(pcm int16[B, 32, L], end int32[L, 2])``.
    """
    if kernel_route() == "triton":
        from bjxa_tpu.ops.pallas_decode import decode_words

        return decode_words(prof, words, state, bits=bits)
    return decode_words_xla(prof, words, state, bits=bits)


def decode_words_xla(prof, words, state, *, bits: int):
    """The ``xla`` route of :func:`decode_words_routed`: bytes back out of
    the words, the lane unpack, then the lane scan."""
    profiles, samples = inflate_lanes(
        words_to_blocks(prof, words, bits=bits), bits
    )
    pcm, end, _valid = decode_lanes(profiles, samples, state)
    return pcm, end


# --------------------------------------------------------------------------
# single file, sequential over blocks (lanes = channels)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("bits",))
def decode_arrays(blocks: jnp.ndarray, state: jnp.ndarray, *, bits: int):
    """Decode one file's blocks; lanes are its channels.

    Args:
      blocks: ``uint8[C, B, block_size]`` raw XA blocks per channel.
      state:  ``int32[C, 2]`` initial predictor state (header befL/befR).

    Returns ``(pcm int16[B*32, C], end_state int32[C, 2], valid bool[B, C])``.
    """
    blocks_t = blocks.transpose(1, 2, 0)  # [B, S, C]
    pcm, end_state, valid = decode_batch_lanes.__wrapped__(
        blocks_t, state, bits=bits
    )
    return pcm.reshape(-1, pcm.shape[-1]), end_state, valid


# --------------------------------------------------------------------------
# single file, chunk-parallel fixed point (lanes = chunks x channels)
# --------------------------------------------------------------------------


def _fixpoint_states(run, anchor, K: int, C: int, max_iters: int):
    """Iterate chunk boundary states to the exact fixed point.

    ``run(states_flat int32[K*C, 2], with_output) -> (pcm|None,
    end int32[K*C, 2])`` decodes every chunk lane from the given input
    states.  Chunk 0 is anchored at ``anchor`` (the true entry state), so
    after i iterations chunks 0..i hold exact states; the loop exits as
    soon as nothing changes (integer equality — exactness is certain, not
    probabilistic).  Returns ``(converged [K, C, 2], iterations)``.
    """

    def propagate(states):
        _, end = run(states.reshape(K * C, 2), False)
        end = end.reshape(K, C, 2)
        return jnp.concatenate([anchor[None], end[:-1]], axis=0)

    def cond(carry):
        states, prev, it = carry
        return jnp.logical_and(it < max_iters, jnp.any(states != prev))

    def body(carry):
        states, _, it = carry
        return propagate(states), states, it + 1

    init = jnp.zeros((K, C, 2), jnp.int32).at[0].set(anchor)
    first = propagate(init)
    states, _, iters = lax.while_loop(
        cond, body, (first, init, jnp.int32(1))
    )
    return states, iters


def _unscramble_chunks(pcm_l, B: int, K: int, C: int):
    """[Bc, 32, K*C] chunk-lane output -> [B*32, C] frames (trim pad)."""
    Bc = pcm_l.shape[0]
    return (
        pcm_l.reshape(Bc, BLOCK_SAMPLES, K, C)
        .transpose(2, 0, 1, 3)
        .reshape(K * Bc * BLOCK_SAMPLES, C)[: B * BLOCK_SAMPLES]
    )


def _end_from_frames(frames, B: int):
    """True end state after the last real block (padded dummy blocks drag
    lane state to zero, so recover it from the decoded samples)."""
    last = B * BLOCK_SAMPLES
    return jnp.stack([frames[last - 1], frames[last - 2]], axis=-1).astype(
        jnp.int32
    )


def fixpoint_lanes_core(
    blocks_t: jnp.ndarray,
    state: jnp.ndarray,
    num_chunks: int,
    channels: int,
    b_total: int,
    *,
    bits: int,
):
    """Chunk-parallel fixed-point decode over lane-major raw blocks.

    The shared core behind every intra-stream parallel decode path.

    Args:
      blocks_t: ``uint8[Bc, S, K*C]`` — raw blocks, lane-minor, lane
        ``l = k*C + c`` (chunk-major, channel-minor); trailing lanes beyond
        ``b_total`` blocks hold valid dummy pad (profile 0, zero samples).
      state:    ``int32[C, 2]`` — true entry state of chunk 0.
      b_total:  real (pre-chunk-padding) block count, ``<= K*Bc``.

    Returns ``(pcm int16[b_total*32, C], end int32[C, 2],
    valid bool[b_total, C], iterations int32)``.
    """
    Bc, S, KC = blocks_t.shape
    K, C = num_chunks, channels
    assert KC == K * C, (KC, K, C)
    anchor = state.astype(jnp.int32)
    run = lanes_decoder(blocks_t, bits)
    states, iters = _fixpoint_states(run, anchor, K, C, max_iters=K)
    pcm_l, _ = run(states.reshape(K * C, 2), True)
    frames = _unscramble_chunks(pcm_l, b_total, K, C)
    valid_l = (blocks_t[:, 0, :] >> 4) < 5  # [Bc, K*C]
    valid = (
        valid_l.reshape(Bc, K, C)
        .transpose(1, 0, 2)
        .reshape(K * Bc, C)[:b_total]
    )
    return frames, _end_from_frames(frames, b_total), valid, iters


def fixpoint_lanes_end_state(
    blocks_t: jnp.ndarray,
    state: jnp.ndarray,
    num_chunks: int,
    channels: int,
    *,
    bits: int,
):
    """States-only twin of :func:`fixpoint_lanes_core`: returns just the
    exact end state ``int32[C, 2]`` after the last block (no sample output
    materialized).  The chunk grid must end exactly at the stream end
    (callers pad with valid dummy blocks and account for them).
    """
    Bc, S, KC = blocks_t.shape
    K, C = num_chunks, channels
    assert KC == K * C, (KC, K, C)
    anchor = state.astype(jnp.int32)
    run = lanes_decoder(blocks_t, bits)
    states, _ = _fixpoint_states(run, anchor, K, C, max_iters=K)
    _, end = run(states.reshape(K * C, 2), False)
    return end.reshape(K, C, 2)[-1]


@partial(jax.jit, static_argnames=("bits", "num_chunks"))
def decode_arrays_fixpoint(
    blocks: jnp.ndarray,
    state: jnp.ndarray,
    *,
    bits: int,
    num_chunks: int,
):
    """Exact chunk-parallel decode of one file via fixed-point iteration.

    Channel-major convenience over :func:`fixpoint_lanes_core` (hosts that
    can stage lane-major should call :func:`decode_fixpoint_lanes` instead
    — it avoids the device transpose).

    Args:
      blocks: ``uint8[C, B, block_size]``; B need not divide num_chunks.
      state:  ``int32[C, 2]``.

    Returns ``(pcm int16[B*32, C], end_state int32[C, 2], valid bool[B, C],
    iterations int32)``.
    """
    C, B, S = blocks.shape
    K = num_chunks
    Bc = -(-B // K)
    # all-zero dummy blocks are valid (profile 0) and get trimmed
    blocks = jnp.pad(blocks, ((0, 0), (0, K * Bc - B), (0, 0)))
    # [C, K, Bc, S] -> [Bc, S, K, C] -> [Bc, S, K*C]
    blocks_t = (
        blocks.reshape(C, K, Bc, S).transpose(2, 3, 1, 0).reshape(Bc, S, K * C)
    )
    return fixpoint_lanes_core(blocks_t, state, K, C, B, bits=bits)


@partial(
    jax.jit,
    static_argnames=("bits", "num_chunks", "channels", "b_total"),
)
def decode_fixpoint_lanes(
    blocks_t: jnp.ndarray,
    state: jnp.ndarray,
    *,
    bits: int,
    num_chunks: int,
    channels: int,
    b_total: int,
):
    """Jitted chunk-parallel decode of host-staged lane-major blocks.

    The single-stream fast path: the host slices the XA payload straight
    into the ``uint8[Bc, S, K*C]`` chunk-lane layout (one numpy copy it
    would pay for any layout), so the device runs no transposes.

    Returns ``(pcm int16[b_total*32, C], end int32[C, 2],
    valid bool[b_total, C], iterations int32)``.
    """
    return fixpoint_lanes_core(
        blocks_t, state, num_chunks, channels, b_total, bits=bits
    )


# --------------------------------------------------------------------------
# many equal-shape channel streams (lanes = N x C)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("bits",))
def decode_batch(blocks: jnp.ndarray, state: jnp.ndarray, *, bits: int):
    """Decode a batch of equal-shape files; lanes = files x channels.

    Channel-major convenience (hosts that can stage lane-major should call
    :func:`decode_batch_lanes` — it avoids the device transposes).

    Args:
      blocks: ``uint8[N, C, B, block_size]``.
      state:  ``int32[N, C, 2]``.

    Returns ``(pcm int16[N, B*32, C], end_state int32[N, C, 2],
    valid bool[B, N, C])``.
    """
    N, C, B, S = blocks.shape
    blocks_t = blocks.transpose(2, 3, 0, 1).reshape(B, S, N * C)
    pcm, end_state, valid_l = decode_batch_lanes.__wrapped__(
        blocks_t, state.reshape(N * C, 2), bits=bits
    )
    frames = (
        pcm.reshape(B, BLOCK_SAMPLES, N, C)
        .transpose(2, 0, 1, 3)
        .reshape(N, B * BLOCK_SAMPLES, C)
    )
    return frames, end_state.reshape(N, C, 2), valid_l.reshape(B, N, C)


@partial(jax.jit, static_argnames=("bits",))
def decode_batch_lanes(blocks_t: jnp.ndarray, state: jnp.ndarray, *, bits: int):
    """Decode lane-major raw blocks.

    Lanes are independent channel streams (files x channels, any order the
    caller chooses) — the host stages ``uint8[B, S, L]`` directly from file
    bytes, and PCM comes back in the same lane order for the host
    serializer to de-interleave per file while writing WAVs.

    Args:
      blocks_t: ``uint8[B, S, L]`` raw blocks, lane-minor.
      state:    ``int32[L, 2]``.

    Returns ``(pcm int16[B, 32, L], end int32[L, 2], valid bool[B, L])``.
    """
    valid = (blocks_t[:, 0, :] >> 4) < 5
    pcm, end = lanes_decoder(blocks_t, bits)(state.astype(jnp.int32), True)
    return pcm, end, valid


@partial(jax.jit, static_argnames=("bits",))
def pack_words_from_lanes(blocks_t: jnp.ndarray, *, bits: int):
    """Pack lane-major raw blocks into the packed-words device layout.

    ``uint8[B, S, L] -> (prof uint8[B, L], words int32[B, bits, L])`` where
    word ``w`` holds payload bytes ``4w..4w+3`` little-endian (the payload
    is ``4*bits`` bytes, so there are exactly ``bits`` words per block).
    Device-side twin of :func:`words_from_blocks_host`.
    """
    B, S, L = blocks_t.shape
    assert S == 4 * bits + 1, (S, bits)
    pay = blocks_t[:, 1:, :].astype(jnp.uint32).reshape(B, bits, 4, L)
    w = (pay[:, :, 0] | (pay[:, :, 1] << 8) | (pay[:, :, 2] << 16)
         | (pay[:, :, 3] << 24))
    return blocks_t[:, 0, :], lax.bitcast_convert_type(w, jnp.int32)


@partial(jax.jit, static_argnames=("bits",))
def words_to_blocks(prof: jnp.ndarray, words: jnp.ndarray, *, bits: int):
    """Inverse of :func:`pack_words_from_lanes`: reassemble
    ``uint8[B, S, L]`` lane-major raw blocks from the words layout (the
    ``xla`` route's unpack reads bytes)."""
    B, W, L = words.shape
    assert W == bits, (W, bits)
    wu = lax.bitcast_convert_type(words, jnp.uint32)
    planes = [((wu >> (8 * q)) & 0xFF).astype(jnp.uint8) for q in range(4)]
    payload = jnp.stack(planes, axis=2).reshape(B, 4 * W, L)
    return jnp.concatenate([prof[:, None, :], payload], axis=1)


def packed_layout(blocks: int, lanes: int, bits: int):
    """Element offsets of the single-buffer batch staging layout.

    A corpus batch ships host->device as ONE int32 buffer concatenating
    the three logical inputs of :func:`decode_batch_words`:

    ``[words int32[B, bits, L] | prof bytes packed 4/int32 | state int32[L, 2]]``

    Returns ``(n_words, n_prof_words, n_state)`` element counts.  One
    transfer instead of three saves two fixed transfer costs per batch.
    """
    n_words = blocks * bits * lanes
    n_prof = -(-(blocks * lanes) // 4)
    return n_words, n_prof, lanes * 2


@partial(jax.jit, static_argnames=("bits", "blocks", "lanes"))
def decode_batch_packed(buf: jnp.ndarray, *, bits: int, blocks: int,
                        lanes: int):
    """Decode one corpus batch from a single packed int32 staging buffer.

    Single-transfer twin of :func:`decode_batch_words` (layout:
    :func:`packed_layout`).  Returns the PCM only, flat (1-D int16, host
    layout ``[blocks, 32, lanes]``): profile validity is the host's job
    (it staged the profile bytes, so ``(prof >> 4) < 5`` costs it
    nothing), and corpus decode never reads the end state.
    """
    B, W, L = blocks, bits, lanes
    nw, npr, _nst = packed_layout(B, L, bits)
    words = buf[:nw].reshape(B, W, L)
    pw = lax.bitcast_convert_type(buf[nw : nw + npr], jnp.uint32)
    pb = jnp.stack([(pw >> (8 * q)) & 0xFF for q in range(4)], axis=-1)
    prof = pb.reshape(-1)[: B * L].astype(jnp.uint8).reshape(B, L)
    state = buf[nw + npr :].reshape(L, 2)
    pcm, _end = decode_words_routed(prof, words, state, bits=bits)
    return pcm.reshape(-1)


@partial(jax.jit, static_argnames=("bits",))
def decode_batch_words(prof: jnp.ndarray, words: jnp.ndarray,
                       state: jnp.ndarray, *, bits: int):
    """Decode packed-words lane-major blocks: the peak-throughput path.

    Same lane semantics as :func:`decode_batch_lanes`, but the payload
    arrives as packed little-endian int32 words, which the fused kernel
    loads one word per lane per load.

    Args:
      prof:  ``uint8[B, L]``; words: ``int32[B, bits, L]`` (see
        :func:`pack_words_from_lanes`); state: ``int32[L, 2]``.

    Returns ``(pcm int16[B, 32, L], end int32[L, 2], valid bool[B, L])``.
    """
    valid = (prof >> 4) < 5
    pcm, end = decode_words_routed(prof, words, state, bits=bits)
    return pcm, end, valid


# --------------------------------------------------------------------------
# host-facing conveniences
# --------------------------------------------------------------------------


def blocks_from_bytes(data: bytes | memoryview, fmt: XAFormat) -> np.ndarray:
    """Slice an XA payload into ``uint8[C, B, block_size]`` (channel-major).

    Stereo files store the left-channel block before the right-channel block
    inside each effective block (``src/libbjxa.c:633-646``).
    """
    need = fmt.blocks * fmt.block_size_xa
    raw = np.frombuffer(data, dtype=np.uint8, count=need)
    return np.ascontiguousarray(
        raw.reshape(fmt.blocks, fmt.channels, fmt.block_size).transpose(
            1, 0, 2
        )
    )


def pad_bucket(nblocks: int, granularity: int = 256) -> int:
    """Round a block count up to a compile-cache-friendly bucket.

    Distinct padded shapes each cost a full compile, so buckets grow
    geometrically: round up to a 4-bit mantissa times a power of two
    (<= 1/8 pad waste — and pad blocks are profile-0 dummies, nearly free
    to decode), then to the linear ``granularity``.  For small counts this
    coincides with plain ``granularity`` rounding; a corpus of arbitrary
    file lengths compiles O(log) programs instead of O(lengths).
    """
    B = nblocks
    e = max(0, B.bit_length() - 4)
    Bp = (-(-B >> e)) << e
    return -(-Bp // granularity) * granularity


def chunk_lanes_from_bytes(
    payload: bytes | memoryview,
    fmt: XAFormat,
    num_chunks: int,
    pad_blocks: int,
) -> np.ndarray:
    """Slice an XA payload straight into the chunk-lane device layout.

    Returns ``uint8[Bc, S, K*C]`` with lane ``l = k*C + c`` — the layout
    :func:`decode_fixpoint_lanes` consumes with zero device transposes.
    ``pad_blocks`` (>= ``fmt.blocks``, a multiple of ``num_chunks``) sets the
    padded block count; dummy pad blocks are all-zero (profile 0 = valid).
    This is one numpy copy — the same cost as any other staging layout.
    """
    B, C, S, K = fmt.blocks, fmt.channels, fmt.block_size, num_chunks
    assert pad_blocks >= B and pad_blocks % K == 0, (pad_blocks, B, K)
    Bc = pad_blocks // K
    raw = np.frombuffer(
        payload, dtype=np.uint8, count=B * fmt.block_size_xa
    ).reshape(B, C, S)
    padded = np.zeros((pad_blocks, C, S), np.uint8)
    padded[:B] = raw
    # [K, Bc, C, S] -> [Bc, S, K, C] -> [Bc, S, K*C]
    return np.ascontiguousarray(
        padded.reshape(K, Bc, C, S).transpose(1, 3, 0, 2)
    ).reshape(Bc, S, K * C)


def words_from_blocks_host(
    blocks_t: np.ndarray, bits: int
) -> tuple[np.ndarray, np.ndarray]:
    """numpy twin of :func:`pack_words_from_lanes` for host staging.

    ``uint8[B, S, L] -> (prof uint8[B, L], words int32[B, bits, L])`` —
    one strided copy (the same cost class as lane-major staging itself)
    followed by a free little-endian int32 view.
    """
    B, S, L = blocks_t.shape
    assert S == 4 * bits + 1, (S, bits)
    prof = np.ascontiguousarray(blocks_t[:, 0, :])
    pay = np.ascontiguousarray(
        blocks_t[:, 1:, :].reshape(B, bits, 4, L).transpose(0, 1, 3, 2)
    )
    words = pay.view("<i4")[..., 0]
    return prof, words


def check_valid(valid: np.ndarray, channels: int) -> None:
    """Raise the EPROTO-equivalent naming the first bad block, if any.

    ``valid``: ``bool[B, C]`` in stream order (channel-minor).
    """
    v = np.asarray(valid)
    if v.all():
        return
    flat = v.reshape(v.shape[0] * channels)
    idx = int(np.argmin(flat))
    raise BjxaProtocolError(
        f"invalid block profile factor in block {idx // channels}"
        f" channel {idx % channels}"
    )


def decode_bytes_validity(
    payload: bytes | memoryview,
    fmt: XAFormat,
    *,
    parallel: bool = True,
    min_chunk_blocks: int = 8,
    max_chunks: int = 4096,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode one XA payload without raising on invalid profiles.

    The shared core of :func:`decode_bytes` and the CLI's valid-prefix
    error path — both go through the same block-count-bucketed compiled
    programs, so a corrupt corpus costs zero extra compiles.

    Returns ``(frames int16[>=samples, C], valid bool[B, C])`` — frames
    past the first invalid block are garbage (the reference stops there;
    callers slice the valid prefix).
    """
    state = fmt.initial_state_array()
    B = fmt.blocks
    # Bucket the block count so files of similar length share one compiled
    # program (dummy profile-0 blocks pad the tail and are trimmed).
    Bp = B if B <= 64 else pad_bucket(B)
    target_lanes = 8192
    num_chunks = min(
        max_chunks,
        max(1, target_lanes // fmt.channels),
        max(1, Bp // min_chunk_blocks),
    )
    while Bp % num_chunks:  # chunk grid must tile the padded block range
        num_chunks -= 1
    if parallel and num_chunks > 1:
        blocks_t = chunk_lanes_from_bytes(payload, fmt, num_chunks, Bp)
        frames, _end, valid, _it = decode_fixpoint_lanes(
            blocks_t,
            state,
            bits=fmt.bits,
            num_chunks=num_chunks,
            channels=fmt.channels,
            b_total=Bp,
        )
    else:
        blocks = blocks_from_bytes(payload, fmt)
        if Bp != B:
            blocks = np.concatenate(
                [
                    blocks,
                    np.zeros(
                        (fmt.channels, Bp - B, fmt.block_size), np.uint8
                    ),
                ],
                axis=1,
            )
        frames, _end, valid = decode_arrays(blocks, state, bits=fmt.bits)
    return frames, valid[:B]


#: Byte budget (payload + PCM) above which whole-file decode/encode
#: switches to the segmented bounded-memory pipelines; override with
#: ``BJXA_SEGMENT_THRESHOLD``.  The format allows u32 sizes
#: (``bjxa.5.rst:77-79``); the reference streams with O(block) memory.
SEGMENT_THRESHOLD = 256 << 20
SEGMENT_BLOCKS = 65536


def segment_threshold() -> int:
    """The active segmentation byte threshold (env-overridable)."""
    import os

    env = os.environ.get("BJXA_SEGMENT_THRESHOLD", "")
    if not env:
        return SEGMENT_THRESHOLD
    try:
        return int(env)
    except ValueError:
        from bjxa_tpu.errors import BjxaInvalidState

        raise BjxaInvalidState(f"Invalid BJXA_SEGMENT_THRESHOLD {env!r}")


def iter_decode_segments(
    read,
    fmt: XAFormat,
    *,
    segment_blocks: int = SEGMENT_BLOCKS,
    parallel: bool = True,
    mesh=None,
    sp_axis: str = "sp",
):
    """Bounded-memory device decode: stream a file through the device in
    fixed-size block segments, carrying the exact predictor end state
    between segments.

    Sequential segments need no boundary fixed point: each segment's entry
    state is the true decoded state (the last two samples of the previous
    segment), so the intra-segment chunk fixpoint runs as usual and the
    yielded PCM is bit-identical to the one-shot path.  Peak memory is
    O(segment) regardless of the header's u32-scale ``data_len`` — the
    device-rate analog of the reference's O(block) streaming loop
    (``src/bjxa_decode.c:102-161``; u32 sizes ``bjxa.5.rst:77-79``).

    All full segments share one compiled program (the tail buckets like
    any short file).

    Args:
      read: ``read(nbytes) -> bytes`` pulling from the stream (a short
        result means the stream is truncated).
      segment_blocks: effective blocks per segment (65536 ≈ 3.2 MB XA /
        16 MB PCM at 6-bit stereo).

    With a multi-device ``mesh`` carrying an ``sp_axis`` of size > 1,
    every segment's block range is additionally sequence-parallel sharded
    across the mesh devices (the ppermute boundary-state ring) — the
    pod-scale path for huge files: O(segment) host memory AND all chips
    decoding, still bit-identical.

    Yields interleaved ``int16[n, channels]`` numpy frames per segment.
    Raises :class:`BjxaProtocolError` after yielding a failing segment's
    valid prefix, or :class:`EOFError` after yielding a truncated
    stream's decoded prefix (callers emit the reference's stderr labels).

    Single-device segments PIPELINE: the carried predictor state stays
    device-resident (the next segment's decode is dispatched against the
    previous segment's not-yet-materialized end state), and each
    segment's PCM transfers back while the next segment is being staged
    and decoded — JAX's async dispatch overlaps read, H2D, compute, and
    D2H across consecutive segments with one extra segment of host
    memory (``benchmarks/bench_segmented.py`` times it).
    """
    import dataclasses

    use_mesh = (
        mesh is not None
        and sp_axis in getattr(mesh, "shape", {})
        and mesh.shape[sp_axis] > 1
    )
    C = fmt.channels
    state = fmt.initial_state_array()  # np carry for the mesh path
    state_dev = None  # device-resident carry for the pipelined path
    left_blocks = fmt.blocks
    done_blocks = 0
    pending = None  # previous segment: (frames_array, n_frames)

    def flush():
        nonlocal pending
        if pending is None:
            return None
        arr, n = pending
        pending = None
        out = np.asarray(arr)[:n]
        return out if out.size else None

    while left_blocks > 0:
        nblk = min(segment_blocks, left_blocks)
        payload = read(nblk * fmt.block_size_xa) or b""
        avail = len(payload) // fmt.block_size_xa
        truncated = avail < nblk
        use = avail if truncated else nblk
        if use == 0:
            out = flush()
            if out is not None:
                yield out
            raise EOFError("truncated XA stream")

        # validity from the profile plane, host-side (no device round
        # trip): block-major, channel-minor like the stream layout
        raw = np.frombuffer(
            payload, np.uint8, count=use * fmt.block_size_xa
        ).reshape(use, C, fmt.block_size)
        vb = (raw[:, :, 0] >> 4) < 5  # [use, C]
        allv = vb.all(axis=1)
        good = int(np.argmin(allv)) if not allv.all() else use
        limit = min(use * BLOCK_SAMPLES,
                    fmt.samples - done_blocks * BLOCK_SAMPLES)
        n_frames = min(good * BLOCK_SAMPLES, limit)

        sub = dataclasses.replace(
            fmt,
            data_len=use * fmt.block_size_xa,
            samples=use * BLOCK_SAMPLES,
        )
        if use_mesh:
            from bjxa_tpu.parallel.sharded import decode_file_sharded

            anchor = state if state_dev is None else state_dev
            frames, _valid, _rounds = decode_file_sharded(
                blocks_from_bytes(payload[: sub.data_len], sub),
                anchor,
                bits=fmt.bits,
                mesh=mesh,
                axis=sp_axis,
            )
            state_dev = None
            if not truncated and use > 0:
                fr = frames[use * BLOCK_SAMPLES - 2: use * BLOCK_SAMPLES]
                state = np.stack([fr[1], fr[0]], axis=-1).astype(np.int32)
        else:
            # pipelined device path: chunk-parallel fixpoint per segment,
            # state carried as a device array (no host sync between
            # dispatches)
            Bp = use if use <= 64 else pad_bucket(use)
            num_chunks = min(
                4096, max(1, 8192 // C), max(1, Bp // 8)
            )
            while Bp % num_chunks:
                num_chunks -= 1
            if parallel and num_chunks > 1:
                blocks_t = chunk_lanes_from_bytes(
                    payload[: sub.data_len], sub, num_chunks, Bp
                )
                anchor = (
                    jnp.asarray(state) if state_dev is None else state_dev
                )
                frames, end_dev, _v, _it = decode_fixpoint_lanes(
                    blocks_t,
                    anchor,
                    bits=fmt.bits,
                    num_chunks=num_chunks,
                    channels=C,
                    b_total=Bp,
                )
            else:
                frames, _valid = decode_bytes_validity(
                    payload[: sub.data_len],
                    dataclasses.replace(
                        sub,
                        initial_state=tuple(
                            tuple(int(x) for x in row)
                            for row in np.asarray(
                                state if state_dev is None else state_dev
                            )
                        )
                        + ((0, 0),) * (2 - C),
                    ),
                    parallel=False,
                )
                end_dev = None
            if Bp == use and end_dev is not None:
                state_dev = end_dev  # exact: no pad blocks ran
            else:
                # pad blocks drag the in-graph end state to zero; the
                # true end lives after the last real block (lazy device
                # slice — still no host sync)
                state_dev = jnp.stack(
                    [
                        frames[use * BLOCK_SAMPLES - 1],
                        frames[use * BLOCK_SAMPLES - 2],
                    ],
                    axis=-1,
                ).astype(jnp.int32)
            fn = getattr(frames, "copy_to_host_async", None)
            if fn is not None:
                fn()

        out = flush()  # previous segment lands while this one decodes
        if out is not None:
            yield out
        pending = (frames, n_frames)
        if good < use:
            out = flush()
            if out is not None:
                yield out
            idx = int(np.argmin(vb.reshape(-1)))
            raise BjxaProtocolError(
                f"invalid block profile factor in block "
                f"{done_blocks + idx // C} channel {idx % C}"
            )
        if truncated:
            out = flush()
            if out is not None:
                yield out
            raise EOFError("truncated XA stream")
        left_blocks -= use
        done_blocks += use
    out = flush()
    if out is not None:
        yield out


def decode_bytes(
    payload: bytes | memoryview,
    fmt: XAFormat,
    *,
    parallel: bool = True,
    min_chunk_blocks: int = 8,
    max_chunks: int = 4096,
    mesh=None,
    sp_axis: str = "sp",
    sp_min_blocks: int = 2048,
) -> np.ndarray:
    """Decode one XA payload to interleaved PCM ``int16[samples, C]``.

    Chooses the chunk-parallel fixed-point pipeline for long streams and the
    plain scan for short ones.  Raises BjxaProtocolError on an invalid
    profile factor anywhere in the stream.

    With a multi-device ``mesh`` carrying an ``sp_axis`` of size > 1 and a
    stream of at least ``sp_min_blocks`` blocks, the block range is
    sequence-parallel sharded across the mesh devices (the ppermute
    boundary-state ring of :func:`bjxa_tpu.parallel.sharded.decode_file_sharded`)
    — bit-exact with the single-device paths.

    Chunk-count heuristic: spread the stream over up to 8192 lanes when it
    is long enough — each chunk
    must still hold enough blocks (``min_chunk_blocks``) that the fixed
    point converges in a few rounds (state transients die within ~5
    blocks).
    """
    if (
        mesh is not None
        and sp_axis in getattr(mesh, "shape", {})
        and mesh.shape[sp_axis] > 1
        and fmt.blocks >= sp_min_blocks
    ):
        from bjxa_tpu.parallel.sharded import decode_file_sharded

        blocks = blocks_from_bytes(payload, fmt)
        pcm, valid, _rounds = decode_file_sharded(
            blocks,
            fmt.initial_state_array(),
            bits=fmt.bits,
            mesh=mesh,
            axis=sp_axis,
        )
        check_valid(valid[: fmt.blocks], fmt.channels)
        return np.asarray(pcm[: fmt.samples])
    frames, valid = decode_bytes_validity(
        payload,
        fmt,
        parallel=parallel,
        min_chunk_blocks=min_chunk_blocks,
        max_chunks=max_chunks,
    )
    check_valid(np.asarray(valid), fmt.channels)
    return np.asarray(frames[: fmt.samples])

"""Exact host-side (numpy) codec path.

This is the jit-free "debug/sanitizer" path (SURVEY §5): bit-exact, obvious
code, no compilation — used by the block-streaming codec objects where jit
dispatch per 32-sample block would dominate, and as the oracle the JAX device
pipelines are differentially tested against.

Semantics follow the format spec (``bjxa.5.rst``): packed samples occupy the
*top* bits of an int16; ``ranged = value >> range`` is an arithmetic shift;
the two-tap gain is divided by 256 truncating toward zero (C division,
``src/libbjxa.c:556-575``); results saturate to int16 and become the new
predictor state, carried across blocks for the life of a channel.
"""

from __future__ import annotations

import numpy as np

from bjxa_tpu.errors import BjxaProtocolError
from bjxa_tpu.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
    NUM_FACTORS,
)


def sign_extend_16(x: np.ndarray) -> np.ndarray:
    """Interpret the low 16 bits of int32 values as int16, keeping int32."""
    x = np.asarray(x, dtype=np.int32)
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def unpack_blocks(payload: np.ndarray, bits: int) -> np.ndarray:
    """Unpack packed sample bytes into int32 "top-bits" sample values.

    ``payload``: ``uint8[..., bits*4]`` (profile byte already stripped).
    Returns ``int32[..., 32]`` holding each packed sample placed in the top
    ``bits`` bits of an int16, sign-extended to int32.
    """
    b = np.asarray(payload, dtype=np.int32)
    if bits == 4:
        hi = (b & 0xF0) << 8
        lo = (b & 0x0F) << 12
        out = np.stack([hi, lo], axis=-1).reshape(*b.shape[:-1], BLOCK_SAMPLES)
    elif bits == 6:
        trip = b.reshape(*b.shape[:-1], 8, 3)
        w = (trip[..., 0] << 16) | (trip[..., 1] << 8) | trip[..., 2]
        s0 = (w & 0x00FC0000) >> 8
        s1 = (w & 0x0003F000) >> 2
        s2 = (w & 0x00000FC0) << 4
        s3 = (w & 0x0000003F) << 10
        out = np.stack([s0, s1, s2, s3], axis=-1).reshape(
            *b.shape[:-1], BLOCK_SAMPLES
        )
    elif bits == 8:
        out = b << 8
    else:
        raise BjxaProtocolError(  # pragma: no cover - validated upstream
            f"unpack_blocks: bad bit depth {bits}"
        )
    return sign_extend_16(out)


def pack_blocks(samples: np.ndarray, bits: int) -> np.ndarray:
    """Pack int16-domain "top-bits" samples back into payload bytes.

    Inverse of :func:`unpack_blocks`: keeps the top ``bits`` bits of each
    16-bit value.  ``samples``: int-like ``[..., 32]``.  Returns
    ``uint8[..., bits*4]``.
    """
    u = np.asarray(samples, dtype=np.int64) & 0xFFFF  # as uint16
    if bits == 4:
        pair = u.reshape(*u.shape[:-1], 16, 2)
        by = ((pair[..., 0] >> 8) & 0xF0) | (pair[..., 1] >> 12)
        return by.astype(np.uint8)
    if bits == 6:
        quad = (u >> 10).reshape(*u.shape[:-1], 8, 4)
        w = (quad[..., 0] << 18) | (quad[..., 1] << 12) | (
            quad[..., 2] << 6
        ) | quad[..., 3]
        out = np.stack(
            [w >> 16, (w >> 8) & 0xFF, w & 0xFF], axis=-1
        ).reshape(*u.shape[:-1], 24)
        return out.astype(np.uint8)
    if bits == 8:
        return (u >> 8).astype(np.uint8)
    raise BjxaProtocolError(f"pack_blocks: bad bit depth {bits}")


def filter_block(
    samples: np.ndarray, profile: int, state: np.ndarray
) -> np.ndarray:
    """Run the two-tap prediction filter over one 32-sample block, in place
    semantics on a copy; ``state`` (``int32[2]``) is updated in place.

    Raises BjxaProtocolError for a profile factor >= 5, as the reference
    does mid-stream (``src/libbjxa.c:550``).
    """
    factor = (int(profile) >> 4) & 0x0F
    shift = int(profile) & 0x0F
    if factor >= NUM_FACTORS:
        raise BjxaProtocolError(f"invalid block profile factor {factor}")
    k0 = int(GAIN_K0[factor])
    k1 = int(GAIN_K1[factor])

    out = np.empty(BLOCK_SAMPLES, dtype=np.int32)
    p0, p1 = int(state[0]), int(state[1])
    vals = np.asarray(samples, dtype=np.int32)
    for n in range(BLOCK_SAMPLES):
        ranged = int(vals[n]) >> shift
        gain = p0 * k0 + p1 * k1
        # C division truncates toward zero
        q = abs(gain) >> 8
        sample = ranged + (q if gain >= 0 else -q)
        sample = min(max(sample, INT16_MIN), INT16_MAX)
        out[n] = sample
        p1 = p0
        p0 = sample
    state[0] = p0
    state[1] = p1
    return out


def decode_channel(
    blocks: np.ndarray, bits: int, state: np.ndarray
) -> np.ndarray:
    """Decode all blocks of one channel sequentially.

    ``blocks``: ``uint8[B, block_size]``; ``state``: ``int32[2]`` updated in
    place.  Returns ``int16[B * 32]``.
    """
    profiles = blocks[:, 0]
    unpacked = unpack_blocks(blocks[:, 1:], bits)
    nblocks = blocks.shape[0]
    out = np.empty((nblocks, BLOCK_SAMPLES), dtype=np.int16)
    for i in range(nblocks):
        out[i] = filter_block(unpacked[i], int(profiles[i]), state)
    return out.reshape(-1)


def _filter_lanes_pass(ranged_t, k0, k1, state_in):
    """One vectorized 32-step filter pass over independent lanes.

    ``ranged_t`` int32[32, L] range-shifted samples, sample-major so each
    step reads a contiguous row (the ``>> range`` is pass-invariant, so
    callers hoist it out of the fixpoint iteration); ``k0/k1`` int32[L];
    ``state_in`` int32[L, 2].  Returns ``(out int32[32, L], end_state
    int32[L, 2])`` — bit-exact per lane given its input state.

    All arithmetic stays in int32 (|gain| < 2^25, well in range): half
    the SIMD cost of int64 math.  The branchless ``(g + ((g >> 31) &
    255)) >> 8`` reproduces C's truncate-toward-zero division, and every
    step runs as in-place ufuncs over three rotating lane buffers — zero
    per-step allocations.
    """
    L = ranged_t.shape[1]
    p0 = state_in[:, 0].copy()
    p1 = state_in[:, 1].copy()
    t = np.empty(L, np.int32)
    out = np.empty_like(ranged_t)
    for n in range(BLOCK_SAMPLES):
        g = out[n]  # computed in place: the output row IS sample n
        np.multiply(p0, k0, out=g)
        np.multiply(p1, k1, out=t)
        g += t
        np.right_shift(g, 31, out=t)
        t &= 255
        g += t
        g >>= 8
        g += ranged_t[n]
        np.minimum(g, INT16_MAX, out=g)
        np.maximum(g, INT16_MIN, out=g)
        p0, p1 = g, p0  # rows n/n-1 are the live predictor taps
    return out, np.stack([p0, p1], axis=-1)


def decode_lanes_fixpoint(
    blocks: np.ndarray, bits: int, state: np.ndarray
) -> np.ndarray:
    """Decode all blocks of all channels with blocks-as-lanes fixed point.

    The batched analog of :func:`decode_channel`: every (block, channel)
    becomes an independent lane, the vectorized filter runs all lanes at
    once from guessed input states, and the per-channel block chain
    (``end_state[i-1] -> in_state[i]``) iterates to a fixed point — the
    numpy mirror of the device chunk fixed point
    (:func:`bjxa_tpu.ops.decode.fixpoint_lanes_core`), exact because a
    pass whose input states already match the serial decode reproduces
    the serial outputs, so the correct prefix grows every pass (typically
    2-3 passes total).  Turns the block-streaming fallback from a Python
    loop per sample into ~32 numpy vector ops per pass.

    ``blocks``: ``uint8[B, C, block_size]`` (valid profiles only);
    ``state``: ``int32[C, 2]``, updated in place to the end state.
    Returns ``int16[B * 32, C]`` interleaved frames.
    """
    B, C, _ = blocks.shape
    profiles = blocks[:, :, 0].astype(np.int32)  # [B, C]
    factors = profiles >> 4
    if (factors >= NUM_FACTORS).any():
        raise BjxaProtocolError("invalid block profile factor")
    vals = unpack_blocks(blocks[:, :, 1:], bits)  # int32[B, C, 32]
    lanes = B * C
    shifts = (profiles & 0x0F).reshape(lanes, 1)
    # sample-major [32, lanes]: each filter step reads/writes a
    # contiguous row instead of a stride-32 column
    ranged_t = np.ascontiguousarray(
        (vals.reshape(lanes, BLOCK_SAMPLES) >> shifts).T
    )
    k0 = GAIN_K0[factors].reshape(lanes).astype(np.int32)
    k1 = GAIN_K1[factors].reshape(lanes).astype(np.int32)

    st_in = np.zeros((B, C, 2), np.int32)
    st_in[0] = state
    out = np.empty((BLOCK_SAMPLES, lanes), np.int32)
    st_end = np.empty((lanes, 2), np.int32)
    # Active-set iteration: a pass only changes the end state of blocks
    # whose INPUT state changed, so each pass recomputes exactly that set
    # (gathered lanes) instead of every lane.  Typical audio: one full
    # pass, one nearly-full pass, then rapidly shrinking tails; the same
    # bound (at most B passes, exact prefix grows monotonically) holds.
    active = np.arange(B)
    lane_off = np.arange(C)
    full = True
    for _ in range(B):
        if full:
            o, se = _filter_lanes_pass(
                ranged_t, k0, k1, st_in.reshape(lanes, 2)
            )
            out[:] = o
            st_end[:] = se
        else:
            li = (active[:, None] * C + lane_off).reshape(-1)
            o, se = _filter_lanes_pass(
                ranged_t[:, li], k0[li], k1[li],
                st_in.reshape(lanes, 2)[li],
            )
            out[:, li] = o
            st_end[li] = se
        se_b = st_end.reshape(B, C, 2)
        nxt = np.concatenate([st_in[:1], se_b[:-1]], axis=0)
        changed = (nxt != st_in).any(axis=(1, 2))
        active = np.nonzero(changed)[0]
        if active.size == 0:
            break
        # near-full active sets run as plain full passes: the gather/
        # scatter copies cost more than recomputing the few settled lanes
        full = active.size * 10 >= B * 9
        st_in[active] = nxt[active]
    state[:] = st_end.reshape(B, C, 2)[-1]
    return (
        out.reshape(BLOCK_SAMPLES, B, C)
        .transpose(1, 0, 2)
        .reshape(B * BLOCK_SAMPLES, C)
        .astype(np.int16)
    )


def encode_truncate_block(pcm: np.ndarray, bits: int) -> tuple[int, np.ndarray]:
    """Reference-compatible "encoder": profile 0, keep top bits only
    (``src/libbjxa.c:665-691``).  ``pcm``: int16[<=32]; zero-padded.
    Returns (profile, payload bytes)."""
    buf = np.zeros(BLOCK_SAMPLES, dtype=np.int16)
    buf[: len(pcm)] = pcm
    return 0, pack_blocks(buf.astype(np.int32), bits)

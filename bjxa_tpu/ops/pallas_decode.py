"""Fused XA decode kernel for the GPU: packed payload words -> filtered PCM.

One Pallas kernel, compiled through Triton, performs everything the
reference does per block (``src/libbjxa.c:629-646``): profile decode,
gain-table lookup, 4/6/8-bit unpack (``:286-345``), range shift, and the
two-tap prediction filter with int16 saturation (``:533-578``) — bit-exact
with every other path.

Layout: lanes are independent channel streams and sit in the minor
dimension, so one thread owns one lane and a warp's loads are coalesced.
The payload arrives as little-endian int32 words (``words int32[B, bits,
L]``, 4 consecutive payload bytes of one lane per word) beside the profile
plane (``prof uint8[B, L]``).  The grid runs over lane tiles only; each
program walks the whole block range with an in-kernel loop and keeps the
predictor state in registers, so nothing is carried between programs and
neither blocks nor lanes need padding (the ragged lane tail is masked).
Each block costs ``1 + 4*bits`` bytes in and 64 bytes out per lane.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bjxa_tpu.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
)

#: Programs wanted in flight before a wider lane tile is worth it: two per
#: SM of an H100 (132 SMs).
MIN_PROGRAMS = 264


def pick_lane_tile(L: int) -> int:
    """Lanes per program: the widest of 128/64/32 that still launches
    :data:`MIN_PROGRAMS` programs, else 32 (one warp)."""
    for lt in (128, 64):
        if -(-L // lt) >= MIN_PROGRAMS:
            return lt
    return 32


def sel_gain(factor, table):
    """``table[min(factor, 4)]`` as a 5-way select chain (no gather)."""
    out = jnp.full_like(factor, int(table[4]))
    for f in range(3, -1, -1):
        out = jnp.where(factor <= f, int(table[f]), out)
    return out


def _sign16(v):
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def _unpack(words, bits: int):
    """The 32 top-bits samples of one block from its ``bits`` payload
    words (int32 vectors over the lane tile), sign-extended int32."""

    def byte(i):
        # payload byte i == byte (i % 4) of little-endian word (i // 4)
        q = i & 3
        w = words[i >> 2]
        return (w >> (8 * q)) & 0xFF if q else w & 0xFF

    out = []
    w24 = None
    for n in range(BLOCK_SAMPLES):
        if bits == 8:
            v = byte(n) << 8
        elif bits == 4:
            bb = byte(n // 2)
            v = (bb & 0xF0) << 8 if n % 2 == 0 else (bb & 0x0F) << 12
        else:  # 6
            q6 = n % 4
            if q6 == 0:
                base = 3 * (n // 4)
                w24 = (byte(base) << 16) | (byte(base + 1) << 8) | byte(
                    base + 2
                )
            v = [
                (w24 & 0x00FC0000) >> 8,
                (w24 & 0x0003F000) >> 2,
                (w24 & 0x00000FC0) << 4,
                (w24 & 0x0000003F) << 10,
            ][q6]
        out.append(_sign16(v))
    return out


def _decode_kernel(prof_ref, words_ref, state_ref, *out_refs, bits: int,
                   lane_tile: int, with_output: bool):
    out_ref, end_ref = out_refs if with_output else (None, out_refs[0])
    nblocks, L = prof_ref.shape
    start = pl.program_id(0) * lane_tile
    lanes = pl.ds(start, lane_tile)
    mask = start + lax.broadcasted_iota(jnp.int32, (lane_tile,), 0) < L

    def load(ref):
        return plgpu.load(ref, mask=mask, other=0)

    def block(b, carry):
        p0, p1 = carry
        prof = load(prof_ref.at[b, lanes]).astype(jnp.int32)
        shift = prof & 0x0F
        k0 = sel_gain(prof >> 4, GAIN_K0)
        k1 = sel_gain(prof >> 4, GAIN_K1)
        words = [load(words_ref.at[b, w, lanes]) for w in range(bits)]
        for n, v in enumerate(_unpack(words, bits)):
            g = p0 * k0 + p1 * k1
            s = (v >> shift) + ((g + ((g >> 31) & 255)) >> 8)
            s = jnp.clip(s, INT16_MIN, INT16_MAX)
            if with_output:
                plgpu.store(
                    out_ref.at[b, n, lanes], s.astype(jnp.int16), mask=mask
                )
            p1 = p0
            p0 = s
        return p0, p1

    p0, p1 = lax.fori_loop(
        0, nblocks, block,
        (load(state_ref.at[0, lanes]), load(state_ref.at[1, lanes])),
    )
    plgpu.store(end_ref.at[0, lanes], p0, mask=mask)
    plgpu.store(end_ref.at[1, lanes], p1, mask=mask)


@partial(
    jax.jit,
    static_argnames=("bits", "with_output", "interpret"),
)
def decode_words(
    prof: jnp.ndarray,
    words: jnp.ndarray,
    state: jnp.ndarray,
    *,
    bits: int,
    with_output: bool = True,
    interpret: bool = False,
):
    """Decode packed-words lane-major blocks with the fused kernel.

    Args:
      prof:  ``uint8[B, L]`` — profile byte per block per lane.
      words: ``int32[B, bits, L]`` — payload as little-endian int32 words
        (word w packs payload bytes ``4w..4w+3``).
      state: ``int32[L, 2]`` — (prev0, prev1) entry state per lane.
      with_output: False computes only the end state (the propagation
        passes of the chunk fixed point); no PCM is written.

    Returns ``(pcm int16[B, 32, L] | None, end int32[L, 2])``.  Profile
    validity is not checked here: callers derive it from ``prof``.
    """
    B, W, L = words.shape
    assert W == bits, (W, bits)
    assert prof.shape == (B, L), (prof.shape, B, L)
    lt = pick_lane_tile(L)
    end_shape = jax.ShapeDtypeStruct((2, L), jnp.int32)
    out_shape = (
        [jax.ShapeDtypeStruct((B, BLOCK_SAMPLES, L), jnp.int16), end_shape]
        if with_output
        else [end_shape]
    )
    outs = pl.pallas_call(
        partial(_decode_kernel, bits=bits, lane_tile=lt,
                with_output=with_output),
        out_shape=out_shape,
        grid=(pl.cdiv(L, lt),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=lt // 32),
        interpret=interpret,
        name="bjxa_decode_words",
    )(prof, words, state.astype(jnp.int32).T)
    end = outs[-1].T
    return (outs[0] if with_output else None), end

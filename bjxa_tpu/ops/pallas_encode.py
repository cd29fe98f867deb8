"""Exhaustive profile-search encode kernel for the GPU (Pallas through
Triton).

The search (:func:`bjxa_tpu.ops.encode.encode_search_scan` is its XLA
twin) evaluates 80 candidate profiles per block, ~12 integer ops per
candidate per sample, with the block order sequential because the chosen
candidate's reconstruction feeds the next block's prediction.  Here one
program owns a tile of lanes and walks the whole block range in an
in-kernel loop, the predictor state in registers.  Within a block the 16
ranges of one factor run side by side as a ``[16, lanes]`` tile, so the
lanes x ranges tile gives each thread its own candidate chains; the
factors and the 32 samples are loops, which keeps the kernel small
enough for Triton to compile in seconds.

Ranking contract, shared with the scan encoder and the native C++
encoder: candidates ordered ``factor*16 + range``, float32 error sums
``err + e*e`` with the square formed exactly in integers (``|e| <=
65535``, so ``e*e`` fits uint32) and rounded once to float32 — the same
value an unfused float multiply gives, and immune to multiply-add
contraction — and a strictly-less comparison, so the first best wins.
The winner is re-run once per block to emit coded values, the exact
decoder reconstruction and the carried state.

Semantics anchored to the format spec (reference ``bjxa.5.rst:110-129``);
the reference encoder itself performs no search (``src/libbjxa.c:679``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bjxa_tpu.ops.pallas_decode import sel_gain
from bjxa_tpu.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
    NUM_FACTORS,
    NUM_RANGES,
)

#: Lanes per program and warps per program: a [16 ranges, 8 lanes] tile
#: on one warp, 4 candidates per thread — the fastest of the tiles swept
#: on the H100 (``PERF.md``, PR 1).
LANE_TILE = 8
NUM_WARPS = 1


def square_f32(e):
    """``float32(e*e)`` for int32 ``|e| <= 65535``: the exact square as
    uint32, rounded once — equal to an unfused float32 multiply."""
    sq = lax.bitcast_convert_type(e * e, jnp.uint32)
    return sq.astype(jnp.float32)


def _trunc_div_256(g):
    return (g + ((g >> 31) & 255)) >> 8


def _encode_kernel(pcm_ref, state_ref, prof_ref, coded_ref, recon_ref,
                   end_ref, *, bits: int):
    nblocks, _, L = pcm_ref.shape
    shq = 16 - bits
    qmin = -(1 << (bits - 1))
    qmax = (1 << (bits - 1)) - 1
    start = pl.program_id(0) * LANE_TILE
    lanes = pl.ds(start, LANE_TILE)
    mask = start + lax.broadcasted_iota(jnp.int32, (LANE_TILE,), 0) < L

    def load(ref):
        return plgpu.load(ref, mask=mask, other=0)

    def store(ref, val):
        plgpu.store(ref, val, mask=mask)

    # per-range quantisation constants of the [16, lanes] candidate tile
    rr = lax.broadcasted_iota(jnp.int32, (NUM_RANGES, LANE_TILE), 0)
    sh_down = jnp.maximum(shq - rr, 0)
    sh_up = jnp.maximum(rr - shq, 0)
    bias = (jnp.ones_like(rr) << sh_down) >> 1
    use_down = rr <= shq

    def quantise(diff, sd, su, bs, down):
        q = jnp.where(down, (diff + bs) >> sd, diff << su)
        return jnp.clip(q, qmin, qmax) << shq

    def block(b, carry):
        p0, p1 = carry  # [lanes]

        def factor(f, best):
            """All 16 ranges of factor ``f``; keep the first best."""
            best_err, best_prof = best
            # gains as tiles: a select over scalars does not lower
            fv = jnp.full(rr.shape, f, jnp.int32)
            k0 = sel_gain(fv, GAIN_K0)
            k1 = sel_gain(fv, GAIN_K1)

            def sample(n, c):
                a0, a1, err = c
                x = load(pcm_ref.at[b, n, lanes])[None, :]
                pred = _trunc_div_256(a0 * k0 + a1 * k1)
                d = quantise(x - pred, sh_down, sh_up, bias, use_down)
                recon = jnp.clip((d >> rr) + pred, INT16_MIN, INT16_MAX)
                return recon, a0, err + square_f32(x - recon)

            _a0, _a1, err = lax.fori_loop(0, BLOCK_SAMPLES, sample, (
                jnp.broadcast_to(p0[None, :], rr.shape),
                jnp.broadcast_to(p1[None, :], rr.shape),
                jnp.zeros(rr.shape, jnp.float32),
            ))
            # first (lowest-range) minimum of this factor, then a strict
            # comparison against the earlier factors' best
            m = jnp.min(err, axis=0)
            r_best = jnp.min(jnp.where(err == m[None, :], rr, NUM_RANGES),
                             axis=0)
            better = m < best_err
            return (jnp.where(better, m, best_err),
                    jnp.where(better, (f << 4) | r_best, best_prof))

        _err, best_prof = lax.fori_loop(0, NUM_FACTORS, factor, (
            jnp.full((LANE_TILE,), jnp.inf, jnp.float32),
            jnp.zeros((LANE_TILE,), jnp.int32),
        ))

        # re-run the winning candidate per lane
        r_l = best_prof & 0x0F
        k0 = sel_gain(best_prof >> 4, GAIN_K0)
        k1 = sel_gain(best_prof >> 4, GAIN_K1)
        sd = jnp.maximum(shq - r_l, 0)
        su = jnp.maximum(r_l - shq, 0)
        bs = (jnp.ones_like(r_l) << sd) >> 1
        down = r_l <= shq

        def emit(n, c):
            q0, q1 = c
            x = load(pcm_ref.at[b, n, lanes])
            pred = _trunc_div_256(q0 * k0 + q1 * k1)
            d = quantise(x - pred, sd, su, bs, down)
            recon = jnp.clip((d >> r_l) + pred, INT16_MIN, INT16_MAX)
            store(coded_ref.at[b, n, lanes], d.astype(jnp.int16))
            store(recon_ref.at[b, n, lanes], recon.astype(jnp.int16))
            return recon, q0

        p0, p1 = lax.fori_loop(0, BLOCK_SAMPLES, emit, (p0, p1))
        store(prof_ref.at[b, lanes], best_prof)
        return p0, p1

    p0, p1 = lax.fori_loop(
        0, nblocks, block,
        (load(state_ref.at[0, lanes]), load(state_ref.at[1, lanes])),
    )
    store(end_ref.at[0, lanes], p0)
    store(end_ref.at[1, lanes], p1)


@partial(jax.jit, static_argnames=("bits", "interpret"))
def encode_search_triton(
    pcm: jnp.ndarray,
    state: jnp.ndarray,
    *,
    bits: int,
    interpret: bool = False,
):
    """Exhaustive-search encode of int-like ``[B, 32, L]`` target PCM.

    Any B and L (the ragged lane tail is masked).  Returns
    ``(profiles int32[B, L], coded int16[B, 32, L], recon int16[B, 32, L],
    end_state int32[L, 2])`` — identical selections to the scan encoder.
    """
    B, ns, L = pcm.shape
    assert ns == BLOCK_SAMPLES
    samp = jax.ShapeDtypeStruct((B, BLOCK_SAMPLES, L), jnp.int16)
    profs, coded, recon, end = pl.pallas_call(
        partial(_encode_kernel, bits=bits),
        out_shape=[
            jax.ShapeDtypeStruct((B, L), jnp.int32),
            samp,
            samp,
            jax.ShapeDtypeStruct((2, L), jnp.int32),
        ],
        grid=(pl.cdiv(L, LANE_TILE),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="bjxa_encode_search",
    )(pcm.astype(jnp.int32), state.astype(jnp.int32).T)
    return profs, coded, recon, end.T

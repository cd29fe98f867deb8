"""Packed-words decode path and the GPU decode kernel (interpret mode).

The words layout (profile plane + little-endian int32 payload words) is a
pure re-staging of the same bytes.  The fused kernel
(:func:`bjxa_tpu.ops.pallas_decode.decode_words`) runs here in Pallas
interpret mode and must match the plain numpy reference sample-for-sample
and state-for-state: every bit depth, ragged lane tails, tiny lane
counts, and the states-only mode.  Reference semantics:
``src/libbjxa.c:286-345`` (inflate) + ``:533-578`` (filter).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bjxa_tpu.ops import numpy_ref
from bjxa_tpu.ops.decode import (
    decode_batch_lanes,
    decode_batch_words,
    pack_words_from_lanes,
    words_from_blocks_host,
    words_to_blocks,
)
from bjxa_tpu.ops.pallas_decode import decode_words
from bjxa_tpu.ops.tables import BLOCK_SAMPLES


def _mk_lanes(bits, B, L, seed=0, max_factor=5):
    rng = np.random.default_rng(seed)
    S = 4 * bits + 1
    blocks_t = rng.integers(0, 256, size=(B, S, L), dtype=np.uint8)
    factor = rng.integers(0, max_factor, size=(B, L))
    shift = rng.integers(0, 16, size=(B, L))
    blocks_t[:, 0, :] = (factor << 4 | shift).astype(np.uint8)
    state = rng.integers(-3000, 3000, size=(L, 2)).astype(np.int32)
    return blocks_t, state


def _numpy_lanes(blocks_t, bits, state):
    """Plain reference: each lane decoded alone by numpy_ref."""
    B, S, L = blocks_t.shape
    pcm = np.empty((B, BLOCK_SAMPLES, L), np.int16)
    end = np.empty((L, 2), np.int32)
    for lane in range(L):
        st = state[lane].copy()
        pcm[:, :, lane] = numpy_ref.decode_channel(
            blocks_t[:, :, lane], bits, st
        ).reshape(B, BLOCK_SAMPLES)
        end[lane] = st
    return pcm, end


def _kernel(blocks_t, bits, state, **kw):
    prof, words = words_from_blocks_host(blocks_t, bits)
    return decode_words(
        jnp.asarray(prof), jnp.asarray(words), jnp.asarray(state),
        bits=bits, interpret=True, **kw,
    )


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_pack_words_roundtrip(bits):
    blocks_t, _ = _mk_lanes(bits, B=6, L=16, seed=1)
    prof, words = pack_words_from_lanes(jnp.asarray(blocks_t), bits=bits)
    back = words_to_blocks(prof, words, bits=bits)
    np.testing.assert_array_equal(np.asarray(back), blocks_t)
    # host stager produces identical words
    hprof, hwords = words_from_blocks_host(blocks_t, bits)
    np.testing.assert_array_equal(hprof, np.asarray(prof))
    np.testing.assert_array_equal(hwords, np.asarray(words))


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_fused_words_kernel_matches_fused_lanes(bits):
    """Kernel equality with numpy_ref at whole lane tiles (64 lanes =
    two 32-lane programs)."""
    blocks_t, state = _mk_lanes(bits, B=5, L=64, seed=2)
    pcm, end = _kernel(blocks_t, bits, state)
    ref_pcm, ref_end = _numpy_lanes(blocks_t, bits, state)
    np.testing.assert_array_equal(np.asarray(pcm), ref_pcm)
    np.testing.assert_array_equal(np.asarray(end), ref_end)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("shape", [(7, 96 + 5), (3, 1), (1, 31)])
def test_fused_words_padded(bits, shape):
    """Ragged lane tails and tiny lane counts: the masked tail program
    writes exactly the real lanes, and no block padding exists."""
    B, L = shape
    blocks_t, state = _mk_lanes(bits, B, L, seed=3)
    pcm, end = _kernel(blocks_t, bits, state)
    ref_pcm, ref_end = _numpy_lanes(blocks_t, bits, state)
    assert pcm.shape == (B, BLOCK_SAMPLES, L)
    np.testing.assert_array_equal(np.asarray(pcm), ref_pcm)
    np.testing.assert_array_equal(np.asarray(end), ref_end)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_batch_words_matches_batch_lanes(bits):
    """Public batch API equality on the active backend (scan route on
    CPU), including the host lane-recovery contract."""
    B, L = 11, 10
    blocks_t, state = _mk_lanes(bits, B, L, seed=4, max_factor=6)
    ref_pcm, ref_end, ref_valid = decode_batch_lanes(
        jnp.asarray(blocks_t), jnp.asarray(state), bits=bits
    )
    prof, words = words_from_blocks_host(blocks_t, bits)
    pcm, end, valid = decode_batch_words(
        jnp.asarray(prof), jnp.asarray(words), jnp.asarray(state), bits=bits
    )
    np.testing.assert_array_equal(np.asarray(pcm), np.asarray(ref_pcm))
    np.testing.assert_array_equal(np.asarray(end), np.asarray(ref_end))
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(ref_valid))


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_fused_words_states_only_device(bits):
    """The states-only mode (with_output=False, the fixpoint's
    propagation pass) returns no PCM and the full pass's end states."""
    blocks_t, state = _mk_lanes(bits, B=8, L=40, seed=9)
    none, end = _kernel(blocks_t, bits, state, with_output=False)
    assert none is None
    _ref_pcm, ref_end = _numpy_lanes(blocks_t, bits, state)
    np.testing.assert_array_equal(np.asarray(end), ref_end)


def _pallas_grid(fn, *args):
    """The grid of the one ``pallas_call`` in ``fn``'s jaxpr."""
    def find(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                return eqn.params["grid_mapping"].grid
            for sub in jax.core.jaxprs_in_params(eqn.params):
                found = find(sub)
                if found is not None:
                    return found
        return None

    return find(jax.make_jaxpr(fn)(*args).jaxpr)


def test_fused_words_explicit_lane_tiles_agree(monkeypatch):
    """Every lane tile the picker can choose (32, 64 and 128 lanes, reached
    with MIN_PROGRAMS lowered to 2) launches that tile's grid and matches
    numpy_ref, ragged tail included."""
    from bjxa_tpu.ops import pallas_decode

    monkeypatch.setattr(pallas_decode, "MIN_PROGRAMS", 2)
    decode_words.clear_cache()  # no trace made under the real constant
    try:
        for L, lt in ((50, 32), (100, 64), (200, 128)):
            assert pallas_decode.pick_lane_tile(L) == lt
            blocks_t, state = _mk_lanes(6, B=4, L=L, seed=6)
            prof, words = words_from_blocks_host(blocks_t, 6)
            args = (jnp.asarray(prof), jnp.asarray(words), jnp.asarray(state))
            fn = partial(decode_words, bits=6, interpret=True)
            assert _pallas_grid(fn, *args) == (-(-L // lt),)
            pcm, end = fn(*args)
            ref_pcm, ref_end = _numpy_lanes(blocks_t, 6, state)
            np.testing.assert_array_equal(np.asarray(pcm), ref_pcm)
            np.testing.assert_array_equal(np.asarray(end), ref_end)
    finally:
        decode_words.clear_cache()


def test_pick_tiles_bounds_padded_memory():
    """The lane tile never exceeds 128 lanes, so the masked tail wastes
    fewer than 128 lanes of work for any lane count, and wide batches
    still launch enough programs to occupy the card."""
    from bjxa_tpu.ops.pallas_decode import MIN_PROGRAMS, pick_lane_tile

    for L in (1, 2, 32, 200, 1025, 8192, 32768, 10**6):
        lt = pick_lane_tile(L)
        assert lt in (32, 64, 128)
        assert -(-L // lt) * lt - L < lt
        if lt > 32:
            assert -(-L // lt) >= MIN_PROGRAMS

"""GPU search-encoder kernel vs the scan encoder, interpret mode.

Small shapes: interpret mode executes op-by-op with the kernel's own
integer and float32 arithmetic; equality here pins identical profile
selection (same candidate order, same exactly-rounded error sums).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bjxa_tpu.ops.encode import encode_search_scan
from bjxa_tpu.ops.pallas_encode import (
    LANE_TILE,
    encode_search_triton,
    square_f32,
)


def _signal(rng, B, L):
    t = np.arange(B * 32)[:, None]
    sig = (
        7000 * np.sin(2 * np.pi * t / 40.0)
        + rng.normal(0, 500, size=(B * 32, L))
    ).astype(np.int16)
    return sig.reshape(B, 32, L).astype(np.int32)


def _assert_same(got, ref):
    for a, b, name in zip(got, ref, ("prof", "coded", "recon", "end")):
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32),
            name,
        )


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_pallas_encode_matches_scan(bits):
    rng = np.random.default_rng(bits)
    B, L = 2, 16
    pcm = _signal(rng, B, L)
    state = rng.integers(-2000, 2000, size=(L, 2)).astype(np.int32)
    ref = encode_search_scan(jnp.asarray(pcm), jnp.asarray(state), bits=bits)
    got = encode_search_triton(
        jnp.asarray(pcm), jnp.asarray(state), bits=bits, interpret=True
    )
    _assert_same(got, ref)


def test_specialized_kernel_matches_on_device():
    """Full-scale noise over six whole lane tiles picks the scan encoder's
    profiles: the regime deepest past the f32 mantissa."""
    rng = np.random.default_rng(11)
    B, L = 2, 6 * LANE_TILE
    pcm = rng.integers(-32768, 32768, size=(B, 32, L)).astype(np.int32)
    state = rng.integers(-3000, 3000, size=(L, 2)).astype(np.int32)
    got = encode_search_triton(jnp.asarray(pcm), jnp.asarray(state), bits=6,
                               interpret=True)
    ref = encode_search_scan(jnp.asarray(pcm), jnp.asarray(state), bits=6)
    _assert_same(got, ref)


def test_wrapper_padded_blocks_end_state_on_device():
    """Odd block count and a ragged lane tail (37 lanes: four full programs
    and a 5-lane masked tail): the end state is the state after the last
    real block."""
    rng = np.random.default_rng(12)
    B, L = 5, 37
    pcm = rng.integers(-32768, 32768, size=(B, 32, L)).astype(np.int32)
    state = rng.integers(-3000, 3000, size=(L, 2)).astype(np.int32)
    got = encode_search_triton(jnp.asarray(pcm), jnp.asarray(state), bits=6,
                               interpret=True)
    ref = encode_search_scan(jnp.asarray(pcm), jnp.asarray(state), bits=6)
    _assert_same(got, ref)


def test_square_f32_is_an_unfused_multiply():
    """square_f32(e) equals numpy's unfused float32 e*e over the whole
    domain |e| <= 65535 — so exact-square accumulation ranks exactly as
    a non-contracted float multiply-then-add does."""
    e = np.arange(-65535, 65536, dtype=np.int32)
    want = e.astype(np.float32) * e.astype(np.float32)
    got = np.asarray(square_f32(jnp.asarray(e)))
    np.testing.assert_array_equal(got, want)

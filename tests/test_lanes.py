"""Lane-major decode paths vs the established pipelines (CPU, bit-exact).

The lane-major layout (``uint8[B, S, L]`` raw blocks, lanes minor) is the
device fast path: hosts stage it for free and the fused kernel reads one
lane per thread.  These tests pin every lane-major component to the
already-golden channel-major pipelines.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from bjxa_tpu.format.xa import XAFormat
from bjxa_tpu.ops.decode import (
    blocks_from_bytes,
    chunk_lanes_from_bytes,
    decode_arrays,
    decode_batch,
    decode_batch_lanes,
    decode_fixpoint_lanes,
)
from bjxa_tpu.ops.inflate import (
    inflate_blocks,
    unpack_payload,
    unpack_payload_lanes,
)

ALL_BITS = (4, 6, 8)


def _rand_blocks(rng, n, c, b, bits, max_factor=5):
    size = bits * 4 + 1
    blocks = rng.integers(0, 256, size=(n, c, b, size), dtype=np.uint8)
    factor = rng.integers(0, max_factor, size=(n, c, b))
    shift = rng.integers(0, 13, size=(n, c, b))
    blocks[..., 0] = (factor << 4 | shift).astype(np.uint8)
    return blocks


@pytest.mark.parametrize("bits", ALL_BITS)
def test_unpack_payload_lanes_matches(bits):
    rng = np.random.default_rng(11)
    B, L = 7, 6
    payload = rng.integers(0, 256, size=(B, bits * 4, L), dtype=np.uint8)
    got = unpack_payload_lanes(jnp.asarray(payload), bits)
    # reference: byte-minor unpack of the transposed payload
    want = unpack_payload(
        jnp.asarray(payload.transpose(0, 2, 1)), bits
    ).transpose(0, 2, 1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.dtype == jnp.int16


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("channels", (1, 2))
def test_decode_batch_lanes_matches_decode_batch(bits, channels):
    rng = np.random.default_rng(12)
    N, B = 5, 9
    blocks = _rand_blocks(rng, N, channels, B, bits)
    states = rng.integers(-3000, 3000, size=(N, channels, 2)).astype(np.int32)

    pcm_ref, end_ref, valid_ref = decode_batch(
        jnp.asarray(blocks), jnp.asarray(states), bits=bits
    )

    L = N * channels
    size = bits * 4 + 1
    blocks_t = np.ascontiguousarray(
        blocks.transpose(2, 3, 0, 1).reshape(B, size, L)
    )
    pcm, end, valid = decode_batch_lanes(
        jnp.asarray(blocks_t), jnp.asarray(states.reshape(L, 2)), bits=bits
    )

    # frames [N, B*32, C] from lane-major pcm [B, 32, L]
    frames = (
        np.asarray(pcm)
        .reshape(B, 32, N, channels)
        .transpose(2, 0, 1, 3)
        .reshape(N, B * 32, channels)
    )
    np.testing.assert_array_equal(frames, np.asarray(pcm_ref))
    np.testing.assert_array_equal(
        np.asarray(end).reshape(N, channels, 2), np.asarray(end_ref)
    )
    np.testing.assert_array_equal(
        np.asarray(valid).reshape(B, N, channels), np.asarray(valid_ref)
    )


def _fmt_for(bits, channels, blocks, rng):
    size = bits * 4 + 1
    data_len = blocks * size * channels
    samples = blocks * 32  # full blocks (tail trimming is host-side)
    state = tuple(
        tuple(int(v) for v in rng.integers(-2000, 2000, 2))
        for _ in range(2)
    )
    return XAFormat(
        data_len=data_len,
        samples=samples,
        samples_rate=44100,
        bits=bits,
        channels=channels,
        initial_state=state,
    )


@pytest.mark.parametrize("bits", ALL_BITS)
@pytest.mark.parametrize("channels", (1, 2))
def test_decode_fixpoint_lanes_matches_sequential(bits, channels):
    rng = np.random.default_rng(13)
    B = 24
    blocks = _rand_blocks(rng, 1, channels, B, bits)[0]  # [C, B, S]
    fmt = _fmt_for(bits, channels, B, rng)
    payload = np.ascontiguousarray(
        blocks.transpose(1, 0, 2)
    ).tobytes()  # stream order: block-major, channel, bytes
    state = fmt.initial_state_array()

    ref_frames, ref_end, ref_valid = decode_arrays(
        jnp.asarray(blocks), jnp.asarray(state), bits=bits
    )

    for K, Bp in ((4, B), (6, B), (8, 32)):
        blocks_t = chunk_lanes_from_bytes(payload, fmt, K, Bp)
        assert blocks_t.shape == (Bp // K, fmt.block_size, K * channels)
        frames, end, valid, iters = decode_fixpoint_lanes(
            jnp.asarray(blocks_t),
            jnp.asarray(state),
            bits=bits,
            num_chunks=K,
            channels=channels,
            b_total=Bp,
        )
        np.testing.assert_array_equal(
            np.asarray(frames)[: B * 32], np.asarray(ref_frames)
        )
        np.testing.assert_array_equal(
            np.asarray(valid)[:B], np.asarray(ref_valid)
        )
        if Bp == B:  # end state comparable only without pad blocks
            np.testing.assert_array_equal(
                np.asarray(end), np.asarray(ref_end)
            )


def test_chunk_lanes_staging_matches_blocks_from_bytes():
    rng = np.random.default_rng(14)
    bits, channels, B = 6, 2, 12
    blocks = _rand_blocks(rng, 1, channels, B, bits)[0]
    fmt = _fmt_for(bits, channels, B, rng)
    payload = np.ascontiguousarray(blocks.transpose(1, 0, 2)).tobytes()

    np.testing.assert_array_equal(blocks_from_bytes(payload, fmt), blocks)

    K, Bp = 3, B
    lanes = chunk_lanes_from_bytes(payload, fmt, K, Bp)
    Bc = Bp // K
    # invert the staging layout and compare to the channel-major slicing
    back = (
        lanes.reshape(Bc, fmt.block_size, K, channels)
        .transpose(3, 2, 0, 1)
        .reshape(channels, K * Bc, fmt.block_size)
    )
    np.testing.assert_array_equal(back, blocks)


@pytest.mark.parametrize("bits", [4, 8])
def test_fixpoint_lanes_core_xla_equals_fused_interpret(bits, monkeypatch,
                                                        request):
    """fixpoint_lanes_core gives the same frames, end state, validity and
    iteration count on the xla route and on the triton route (kernel in
    interpret mode)."""
    from bjxa_tpu.ops.decode import fixpoint_lanes_core

    rng = np.random.default_rng(15)
    K, C, Bc = 4, 2, 6
    size = bits * 4 + 1
    blocks_t = rng.integers(0, 256, size=(Bc, size, K * C), dtype=np.uint8)
    factor = rng.integers(0, 5, size=(Bc, K * C))
    shift = rng.integers(0, 13, size=(Bc, K * C))
    blocks_t[:, 0, :] = (factor << 4 | shift).astype(np.uint8)
    state = rng.integers(-3000, 3000, size=(C, 2)).astype(np.int32)

    def run():
        return [np.asarray(x) for x in fixpoint_lanes_core(
            jnp.asarray(blocks_t), jnp.asarray(state), K, C, K * Bc - 3,
            bits=bits,
        )]

    ref = run()
    request.getfixturevalue("triton_interpret")
    for got, want in zip(run(), ref):
        np.testing.assert_array_equal(got, want)


def test_fixpoint_and_packed_tiny():
    """Tiny direct drives of decode_arrays_fixpoint and the packed
    single-buffer batch path against decode_arrays."""
    import numpy as np

    from bjxa_tpu.ops.decode import (
        decode_arrays,
        decode_arrays_fixpoint,
        decode_batch_packed,
        packed_layout,
    )

    rng = np.random.default_rng(17)
    bits, C, B = 6, 2, 12
    S = 4 * bits + 1
    blocks = rng.integers(0, 256, size=(C, B, S), dtype=np.uint8)
    blocks[:, :, 0] = (
        rng.integers(0, 5, size=(C, B)) << 4
        | rng.integers(0, 4, size=(C, B))
    ).astype(np.uint8)
    state = rng.integers(-100, 100, size=(C, 2)).astype(np.int32)
    ref, ref_end, _ = decode_arrays(blocks, state, bits=bits)

    pcm, end, valid, iters = decode_arrays_fixpoint(
        blocks, state, bits=bits, num_chunks=3
    )
    np.testing.assert_array_equal(np.asarray(pcm), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(end), np.asarray(ref_end))

    # packed single-buffer path (lanes = channels of this one file)
    L = C
    W = bits
    nw, npr, nst = packed_layout(B, L, bits)
    buf = np.zeros(nw + npr + nst, np.dtype("<i4"))
    words8 = buf[:nw].view(np.uint8).reshape(B, W, L, 4)
    prof = buf[nw : nw + npr].view(np.uint8)[: B * L].reshape(B, L)
    st = buf[nw + npr :].reshape(L, 2)
    raw = blocks.transpose(1, 0, 2)  # [B, C, S]
    prof[:] = raw[:, :, 0]
    words8[:] = raw[:, :, 1:].reshape(B, C, W, 4).transpose(0, 2, 1, 3)
    st[:] = state
    flat = np.asarray(
        decode_batch_packed(buf, bits=bits, blocks=B, lanes=L)
    )
    got = flat.reshape(B, 32, L).reshape(B * 32, L)
    np.testing.assert_array_equal(got, np.asarray(ref))

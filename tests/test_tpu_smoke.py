"""Small-shape smoke tests that drive every device-dispatch entry point.

On the CPU run these take the ``xla`` kernel route; the same entry points
take the ``triton`` route on the GPU (``chip_smoke.py`` drives them there
at full size).  Shapes are tiny so compiles stay cheap.
"""

import numpy as np
import pytest

from bjxa_tpu.ops import numpy_ref
from bjxa_tpu.ops.tables import block_size_for_bits


def _random_stream(rng, channels, nblocks, bits):
    size = block_size_for_bits(bits)
    blocks = rng.integers(
        0, 256, size=(channels, nblocks, size), dtype=np.uint8
    )
    factor = rng.integers(0, 5, size=(channels, nblocks))
    shift = rng.integers(0, 4, size=(channels, nblocks))
    blocks[:, :, 0] = (factor << 4 | shift).astype(np.uint8)
    return blocks


def _oracle(blocks, bits, state):
    st = state.copy()
    chans = [
        numpy_ref.decode_channel(blocks[c], bits, st[c])
        for c in range(blocks.shape[0])
    ]
    return np.stack(chans, axis=-1), st


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_batch_words_smoke(bits):
    from bjxa_tpu.ops.decode import decode_batch_words

    rng = np.random.default_rng(bits)
    C, B = 2, 6
    blocks = _random_stream(rng, C, B, bits)
    size = block_size_for_bits(bits)
    state = rng.integers(-300, 300, size=(C, 2)).astype(np.int32)

    prof = blocks[:, :, 0].T.copy()  # [B, C] lanes
    words = np.ascontiguousarray(
        blocks[:, :, 1:].reshape(C, B, bits, 4).transpose(1, 2, 0, 3)
    ).view("<i4")[..., 0]
    pcm, end, valid = decode_batch_words(prof, words, state, bits=bits)
    pcm = np.asarray(pcm).reshape(np.asarray(pcm).shape[0], 32, -1)[
        :B, :, :C
    ]
    ref, ref_state = _oracle(blocks, bits, state)
    assert np.asarray(valid)[:B, :C].all()
    np.testing.assert_array_equal(pcm.reshape(B * 32, C), ref)
    np.testing.assert_array_equal(np.asarray(end)[:C], ref_state)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_batch_lanes_smoke(bits):
    from bjxa_tpu.ops.decode import decode_batch_lanes

    rng = np.random.default_rng(10 + bits)
    C, B = 2, 5
    blocks = _random_stream(rng, C, B, bits)
    state = np.zeros((C, 2), np.int32)
    blocks_t = np.ascontiguousarray(blocks.transpose(1, 2, 0))  # [B, S, C]
    pcm, end, valid = decode_batch_lanes(blocks_t, state, bits=bits)
    ref, ref_state = _oracle(blocks, bits, state)
    assert np.asarray(valid).all()
    np.testing.assert_array_equal(
        np.asarray(pcm).reshape(B * 32, C), ref
    )
    np.testing.assert_array_equal(np.asarray(end), ref_state)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_bytes_smoke(bits):
    """decode_bytes auto-path on a small stream (fixpoint pipeline)."""
    from bjxa_tpu.format.xa import XAFormat
    from bjxa_tpu.ops.decode import decode_bytes

    rng = np.random.default_rng(20 + bits)
    C, B = 2, 9
    blocks = _random_stream(rng, C, B, bits)
    payload = np.ascontiguousarray(
        blocks.transpose(1, 0, 2)
    ).tobytes()  # file order: per effective block, ch0 then ch1
    fmt = XAFormat(
        data_len=len(payload),
        samples=B * 32,
        samples_rate=44100,
        bits=bits,
        channels=C,
        initial_state=((0, 0), (0, 0)),
    )
    pcm = decode_bytes(payload, fmt)
    ref, _ = _oracle(blocks, bits, np.zeros((C, 2), np.int32))
    np.testing.assert_array_equal(np.asarray(pcm), ref)


def test_encode_search_smoke():
    """encode_search dispatch (kernel on the GPU, scan on the CPU)
    round-trips."""
    import jax.numpy as jnp

    from bjxa_tpu.ops.decode import decode_batch_lanes
    from bjxa_tpu.ops.deflate import deflate_blocks
    from bjxa_tpu.ops.encode import encode_search

    rng = np.random.default_rng(5)
    B, L = 4, 2
    pcm = rng.integers(-25000, 25000, size=(B, 32, L)).astype(np.int32)
    profiles, coded, recon, end = encode_search(
        jnp.asarray(pcm), jnp.zeros((L, 2), jnp.int32), bits=6
    )
    blocks = np.asarray(
        deflate_blocks(profiles, jnp.asarray(coded).transpose(0, 2, 1), 6)
    )  # [B, L, S]
    # decoding the emitted blocks reproduces the predicted reconstruction
    out, _end, valid = decode_batch_lanes(
        np.ascontiguousarray(blocks.transpose(0, 2, 1)),
        np.zeros((L, 2), np.int32),
        bits=6,
    )
    assert np.asarray(valid).all()
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(recon)
    )

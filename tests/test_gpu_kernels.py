"""The Pallas kernels compiled for the card (skip without a GPU).

On a GPU host: ``python -m pytest -m gpu tests/test_gpu_kernels.py``.
``chip_smoke.py`` phase ``kernels`` runs the same comparisons at the
benchmark's widths.
"""

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_kernel_compiled_matches_xla(bits):
    from bjxa_tpu.ops.decode import decode_words_xla
    from bjxa_tpu.ops.pallas_decode import decode_words

    rng = np.random.default_rng(bits)
    B, L = 16, 4099
    words = rng.integers(-(2**31), 2**31, (B, bits, L)).astype(np.int32)
    prof = (rng.integers(0, 5, (B, L)) << 4
            | rng.integers(0, 13, (B, L))).astype(np.uint8)
    state = rng.integers(-3000, 3000, (L, 2)).astype(np.int32)
    got = decode_words(jnp.asarray(prof), jnp.asarray(words),
                       jnp.asarray(state), bits=bits)
    want = decode_words_xla(jnp.asarray(prof), jnp.asarray(words),
                            jnp.asarray(state), bits=bits)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_encode_kernel_compiled_matches_xla(bits):
    from bjxa_tpu.ops.encode import encode_search_scan
    from bjxa_tpu.ops.pallas_encode import encode_search_triton

    rng = np.random.default_rng(bits)
    pcm = rng.integers(-32768, 32768, (4, 32, 1000)).astype(np.int32)
    state = np.zeros((1000, 2), np.int32)
    got = encode_search_triton(jnp.asarray(pcm), jnp.asarray(state),
                               bits=bits)
    want = encode_search_scan(jnp.asarray(pcm), jnp.asarray(state),
                              bits=bits)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int32),
                                      np.asarray(b).astype(np.int32))

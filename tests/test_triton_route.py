"""The GPU (``triton``) kernel route, end to end, on the CPU.

The ``triton_interpret`` fixture makes ``kernel_route()`` answer
``"triton"`` and runs the Pallas kernels in interpret mode, so each
pipeline below traces exactly the kernel calls it makes on the card —
the fixpoint decoder, the packed corpus batch, the search encoder, the
sequence-parallel ring under ``shard_map`` — and is compared with the
plain references.  The last tests lower both kernels for CUDA, which
checks on the CPU that every primitive they use has a Triton lowering.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bjxa_tpu import native
from bjxa_tpu.format import XAFormat, dump_xa_header, parse_xa_header
from bjxa_tpu.ops import numpy_ref

pytestmark = pytest.mark.usefixtures("triton_interpret")


def _random_xa(rng, bits, channels, nblocks):
    size = 4 * bits + 1
    body = rng.integers(0, 256, (nblocks, channels, size), dtype=np.uint8)
    body[:, :, 0] = (
        rng.integers(0, 5, (nblocks, channels)) << 4
        | rng.integers(0, 13, (nblocks, channels))
    ).astype(np.uint8)
    fmt = XAFormat(
        data_len=body.size,
        samples=nblocks * 32 - 7,
        samples_rate=44100,
        bits=bits,
        channels=channels,
        initial_state=((100, -50), (7, 9)),
    )
    return fmt, body


def _reference(fmt, body):
    state = fmt.initial_state_array().copy()
    chans = [
        numpy_ref.decode_channel(body[:, c], fmt.bits, state[c])
        for c in range(fmt.channels)
    ]
    return np.stack(chans, axis=-1)[: fmt.samples]


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_decode_bytes_triton_route(bits):
    """Whole-file decode: the chunk fixpoint over the kernel's
    states-only and full passes."""
    from bjxa_tpu.ops.decode import decode_bytes

    fmt, body = _random_xa(np.random.default_rng(bits), bits, 2, 40)
    got = decode_bytes(body.tobytes(), fmt)
    np.testing.assert_array_equal(got, _reference(fmt, body))


def test_corpus_triton_route(tmp_path):
    """The corpus engine's packed single-buffer batch on the kernel."""
    from bjxa_tpu.parallel.corpus import decode_corpus

    rng = np.random.default_rng(5)
    src = tmp_path / "xa"
    src.mkdir()
    want = {}
    for i, (bits, ch, nb) in enumerate([(4, 1, 9), (6, 2, 20), (6, 2, 13)]):
        fmt, body = _random_xa(rng, bits, ch, nb)
        header = dump_xa_header(fmt)
        (src / f"f{i}.xa").write_bytes(header + body.tobytes())
        want[f"f{i}"] = _reference(parse_xa_header(header), body)
    res = decode_corpus(src, tmp_path / "wav")
    assert res.converted == 3 and not res.failed
    for stem, pcm in want.items():
        data = (tmp_path / "wav" / f"{stem}.wav").read_bytes()[44:]
        np.testing.assert_array_equal(
            np.frombuffer(data, "<i2").reshape(pcm.shape), pcm
        )


@pytest.mark.parametrize("fixpoint", ["0", "auto"])
def test_encode_pcm_triton_route(fixpoint, monkeypatch):
    """Search encode on the kernel, sequential and chunk fixpoint, is
    byte-identical to the native C++ encoder."""
    from bjxa_tpu.api import encode_pcm

    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", fixpoint)
    rng = np.random.default_rng(9)
    pcm = rng.integers(-30000, 30000, size=(64 * 32 + 5, 2)).astype(np.int16)
    got = encode_pcm(pcm, 44100, 6)
    padded = np.zeros((65 * 32, 2), np.int16)
    padded[: len(pcm)] = pcm
    blocks = native.encode_blocks(padded, 6, np.zeros((2, 2), np.int32),
                                  search=True)
    assert got[32:] == blocks.tobytes()


def test_sharded_ring_triton_route():
    """The sequence-parallel ppermute ring with the kernel inside
    shard_map, on four virtual devices."""
    from bjxa_tpu.parallel import decode_file_sharded, make_mesh

    fmt, body = _random_xa(np.random.default_rng(3), 6, 2, 70)
    mesh = make_mesh(jax.devices()[:4], dp=4, sp=1, axis_names=("sp", "_"))
    pcm, valid, _rounds = decode_file_sharded(
        np.ascontiguousarray(body.transpose(1, 0, 2)),
        fmt.initial_state_array(), bits=6, mesh=mesh, local_chunks=2,
    )
    assert valid.all()
    np.testing.assert_array_equal(pcm[: fmt.samples], _reference(fmt, body))


def test_transcode_step_triton_route():
    """The flagship decode + search re-encode step runs both kernels."""
    from bjxa_tpu.ops.decode import decode_batch
    from bjxa_tpu.ops.encode import encode_search_scan
    from bjxa_tpu.parallel.pipeline import transcode_step

    rng = np.random.default_rng(4)
    _fmt, body = _random_xa(rng, 6, 2, 3)
    blocks = jnp.asarray(body.transpose(1, 0, 2)[None])  # [1, C, B, S]
    states = jnp.zeros((1, 2, 2), jnp.int32)
    xa, mse = transcode_step(blocks, states, bits=6)
    pcm = np.asarray(decode_batch(blocks, states, bits=6)[0])[0]
    lanes = jnp.asarray(pcm.reshape(3, 32, 2).astype(np.int32))
    prof = np.asarray(
        encode_search_scan(lanes, jnp.zeros((2, 2), jnp.int32), bits=6)[0]
    )
    np.testing.assert_array_equal(np.asarray(xa)[0, :, :, 0], prof)
    assert np.isfinite(float(mse))


def _lower_for_cuda(fn, *shapes):
    from jax import export

    exp = export.export(
        jax.jit(fn),
        platforms=("cuda",),
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*shapes)
    return exp.mlir_module()


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("with_output", [True, False])
def test_decode_kernel_lowers_for_cuda(bits, with_output):
    from bjxa_tpu.ops import pallas_decode

    S = jax.ShapeDtypeStruct
    L = 1000  # ragged: 32 programs of 32 lanes, the last one masked
    mod = _lower_for_cuda(
        lambda p, w, s: pallas_decode.decode_words.func(
            p, w, s, bits=bits, with_output=with_output
        ),
        S((20, L), jnp.uint8), S((20, bits, L), jnp.int32),
        S((L, 2), jnp.int32),
    )
    assert mod.count("__gpu$xla.gpu.triton") == 1
    assert "bjxa_decode_words" in mod


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_encode_kernel_lowers_for_cuda(bits):
    from bjxa_tpu.ops import pallas_encode

    S = jax.ShapeDtypeStruct
    mod = _lower_for_cuda(
        lambda x, s: pallas_encode.encode_search_triton.func(
            x, s, bits=bits
        ),
        S((3, 32, 100), jnp.int32), S((100, 2), jnp.int32),
    )
    assert mod.count("__gpu$xla.gpu.triton") == 1
    assert "bjxa_encode_search" in mod

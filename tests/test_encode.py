"""Encoder tests: reference-compatible truncation mode, the profile-search
encoder's SNR floor (must exceed the measured reference baselines,
BASELINE.md), reconstruction consistency, and header round-trips.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bjxa_tpu.api import decode_xa, encode_pcm, wav_to_xa
from bjxa_tpu.format import parse_xa_header
from bjxa_tpu.ops.encode import encode_search
from bjxa_tpu.ops import numpy_ref

# round-trip SNR of the reference (truncation) encoder on square-mono.wav,
# measured during the survey — the search encoder must beat these.
REFERENCE_SNR = {4: 16.6, 6: 28.8, 8: 40.8}


def snr_db(x, y):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return 10 * np.log10((x**2).sum() / ((x - y) ** 2).sum())


def synth_signal(n=44100, channels=1, seed=5):
    t = np.arange(n)[:, None]
    phases = np.array([[0.0, 1.1]])[:, :channels]
    sig = (
        9000 * np.sin(2 * np.pi * 440 * t / 44100 + phases)
        + 4000 * np.sin(2 * np.pi * 1327 * t / 44100)
        + 1500 * np.sin(2 * np.pi * 53 * t / 44100)
    )
    rng = np.random.default_rng(seed)
    sig += rng.normal(0, 60, size=(n, channels))
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize(
    "channels", [1, pytest.param(2, marks=pytest.mark.slow)]
)
def test_search_beats_reference_snr(bits, channels):
    sig = synth_signal(44100, channels)
    xa = encode_pcm(sig, 44100, bits, search=True)
    _, dec = decode_xa(xa)
    assert snr_db(sig, dec) > REFERENCE_SNR[bits] + 3.0


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_search_beats_truncation(bits):
    sig = synth_signal(22050)
    xa_t = encode_pcm(sig, 44100, bits, search=False)
    xa_s = encode_pcm(sig, 44100, bits, search=True)
    _, dec_t = decode_xa(xa_t)
    _, dec_s = decode_xa(xa_s)
    assert snr_db(sig, dec_s) > snr_db(sig, dec_t)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_recon_matches_decoder(bits):
    """The search encoder's in-loop reconstruction must equal what the real
    decoder produces from its output — filter-in-the-loop exactness."""
    sig = synth_signal(32 * 40)
    lanes = sig.reshape(-1, 32, 1).astype(np.int32)
    profiles, coded, recon, _ = encode_search(
        jnp.asarray(lanes), jnp.zeros((1, 2), jnp.int32), bits=bits
    )
    xa = encode_pcm(sig, 44100, bits, search=True)
    _, dec = decode_xa(xa)
    np.testing.assert_array_equal(
        np.asarray(recon).reshape(-1), dec[:, 0]
    )


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("channels", [1, 2])
def test_truncation_matches_numpy_oracle(bits, channels):
    """Truncation mode must equal the reference algorithm (profile 0, keep
    top bits, zero-pad the final partial block) — here via the numpy
    oracle; byte-compatibility with the C binary is covered by the
    differential suite."""
    sig = synth_signal(32 * 10 + 7, channels)  # partial last block
    xa = encode_pcm(sig, 44100, bits, search=False)
    fmt = parse_xa_header(xa)
    assert fmt.samples == len(sig)
    assert fmt.blocks == 11
    payload = np.frombuffer(xa[32:], np.uint8).reshape(
        fmt.blocks, channels, fmt.block_size
    )
    padded = np.zeros((fmt.blocks * 32, channels), np.int16)
    padded[: len(sig)] = sig
    for b in range(fmt.blocks):
        for c in range(channels):
            prof, data = numpy_ref.encode_truncate_block(
                padded[b * 32 : (b + 1) * 32, c], bits
            )
            assert payload[b, c, 0] == prof
            np.testing.assert_array_equal(payload[b, c, 1:], data)


def test_header_roundtrip():
    sig = synth_signal(1000, 2)
    xa = encode_pcm(sig, 22050, 6)
    fmt = parse_xa_header(xa)
    assert fmt.channels == 2
    assert fmt.samples == 1000
    assert fmt.samples_rate == 22050
    assert fmt.bits == 6
    assert fmt.data_len == fmt.blocks * fmt.block_size_xa


def test_wav_roundtrip_padding():
    """Odd-length stream: decode(encode(wav)) keeps exactly `samples`
    frames, discarding pad."""
    sig = synth_signal(32 * 5 + 13)
    xa = encode_pcm(sig, 44100, 8, search=True)
    _, dec = decode_xa(xa)
    assert dec.shape == (32 * 5 + 13, 1)
    assert snr_db(sig, dec) > REFERENCE_SNR[8]


# -- profile-search ranking contract (VERDICT r3 item 7) ---------------------
#
# The contract (docs/bjxa-tpu.3.md "Profile-search ranking contract"):
# the winning candidate minimizes reconstruction error energy accumulated
# in float32, in sample order, over candidates ordered factor*16+range
# with a strictly-less argmin (ties keep the earliest candidate).  All
# implementations share that exact arithmetic, so they always agree;
# tools/encode_rank_probe.py measures that f32 ranking never diverges
# from exact int64 ranking on random blocks (0/80k; min top-2 exact gap
# 1.1e-3 relative vs the 4e-6 f32 accumulation error bound).


def _all_impl_profiles(pcm, bits):
    """Profiles picked by the scan encoder, the GPU kernel (interpret
    mode: op-by-op equality pins the compiled kernel's arithmetic) and
    the native C++ encoder.  ``pcm``: ``int32[B, 32, 16]``."""
    from bjxa_tpu.ops.encode import encode_search_scan
    from bjxa_tpu.ops.pallas_encode import encode_search_triton

    B, _, L = pcm.shape
    assert L == 16, L
    state = np.zeros((L, 2), np.int32)
    prof_scan, _, _, _ = encode_search_scan(
        jnp.asarray(pcm), jnp.asarray(state), bits=bits
    )
    prof_pl, _, _, _ = encode_search_triton(
        jnp.asarray(pcm), jnp.asarray(state), bits=bits, interpret=True
    )
    out = [np.asarray(prof_scan), np.asarray(prof_pl)]
    from bjxa_tpu import native

    if native.available():
        # one mono stream per lane (lanes are independent by contract)
        prof_nat = np.empty((B, L), np.int32)
        for lane in range(L):
            st = np.zeros((1, 2), np.int32)
            blocks = native.encode_blocks(
                np.ascontiguousarray(
                    pcm[:, :, lane].reshape(-1, 1)
                ).astype(np.int16),
                bits,
                st,
                search=True,
            )
            prof_nat[:, lane] = blocks[:, 0, 0]
        out.append(prof_nat)
    return out


def test_rank_contract_exact_tie_breaks_to_first_candidate():
    """A multi-way EXACT tie (several candidates reconstruct with zero
    error): the strictly-less argmin keeps the earliest candidate in
    order, so profile 0x00 wins — pinned across all implementations."""
    rng = np.random.default_rng(11)
    # multiples of 1024 within headroom: factor 0 reconstructs them
    # exactly at range 0 AND range 1 (at least) -> exact zero-error tie
    pcm = (rng.integers(-14, 14, size=(1, 32, 16)) * 1024).astype(np.int32)
    for prof in _all_impl_profiles(pcm, 6):
        assert prof.reshape(-1).tolist() == [0] * 16, prof


def test_rank_contract_near_tie_pins_candidate_order():
    """A constructed near-tie: constant 1536 is missed by candidate 0
    (range 0 quantizes to 2048) but nailed by candidate 1 (range 1), so
    profile 0x01 must win in every implementation."""
    pcm = np.full((1, 32, 16), 1536, np.int32)
    for prof in _all_impl_profiles(pcm, 6):
        assert prof.reshape(-1).tolist() == [1] * 16, prof


def test_rank_contract_impls_agree_on_high_energy_blocks():
    """Full-scale noise blocks (error energy ~1e11, deep past the f32
    mantissa): every implementation still picks identical profiles — the
    shared-arithmetic half of the ranking contract."""
    rng = np.random.default_rng(13)
    pcm = rng.integers(-32768, 32768, size=(1, 32, 16)).astype(np.int32)
    profs = _all_impl_profiles(pcm, 6)
    for other in profs[1:]:
        np.testing.assert_array_equal(profs[0], other)


# -- chunk-parallel search fixpoint (single-stream occupancy) ----------------


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("nblocks", [64, 130, 257])
def test_encode_fixpoint_matches_sequential(channels, nblocks):
    """encode_search_fixpoint is bit-identical to the sequential greedy
    search — profiles, coded values, reconstruction, and end state — for
    odd block counts, stereo, nonzero entry states, and adversarial
    full-scale noise."""
    import jax.numpy as jnp

    from bjxa_tpu.ops.encode import encode_search_fixpoint

    rng = np.random.default_rng(nblocks * channels)
    pcm = rng.integers(
        -32768, 32768, size=(nblocks, 32, channels)
    ).astype(np.int32)
    state = rng.integers(-3000, 3000, size=(channels, 2)).astype(np.int32)
    sp, sc, sr, se = encode_search(
        jnp.asarray(pcm), jnp.asarray(state), bits=6
    )
    fp, fc, fr, fe, rounds = encode_search_fixpoint(
        pcm, state, bits=6, num_chunks=16
    )
    np.testing.assert_array_equal(fp, np.asarray(sp))
    np.testing.assert_array_equal(fc, np.asarray(sc))
    np.testing.assert_array_equal(fr, np.asarray(sr))
    np.testing.assert_array_equal(fe, np.asarray(se))
    assert 1 <= rounds <= 16


def test_encode_pcm_routes_through_fixpoint(monkeypatch):
    """With BJXA_ENCODE_FIXPOINT_CHUNKS set (the CPU default is
    sequential), encode_pcm routes long streams through the chunk
    fixpoint and produces identical bytes."""
    from bjxa_tpu.ops import encode as enc_mod

    rng = np.random.default_rng(3)
    pcm = rng.integers(-25000, 25000, size=(200 * 32, 2)).astype(np.int16)
    want = encode_pcm(pcm, 44100, 6, search=True)

    calls = []
    orig = enc_mod.encode_search_fixpoint

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(enc_mod, "encode_search_fixpoint", spy)
    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "auto")
    got = encode_pcm(pcm, 44100, 6, search=True)
    assert calls and all(1 <= r <= 8192 for r in calls)
    assert got == want  # bit-identical bytes either way


# -- link-adaptive fixpoint default + env parsing ---------------------------


def test_pick_encode_chunks_env_matrix(monkeypatch):
    """Every BJXA_ENCODE_FIXPOINT_CHUNKS value class: forced off, auto,
    forced K (clamped), short-stream floor, and malformed -> clean error
    (not a bare ValueError traceback)."""
    from bjxa_tpu.errors import BjxaInvalidState
    from bjxa_tpu.ops.encode import pick_encode_chunks

    for off in ("0", "off"):
        monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", off)
        assert pick_encode_chunks(4096, 2) == 1
    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "auto")
    assert pick_encode_chunks(4096, 2) == 256  # nblocks // 16
    assert pick_encode_chunks(10**6, 2) == 4096  # 8192 // channels
    assert pick_encode_chunks(32, 2) == 1  # short-stream floor
    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "512")
    assert pick_encode_chunks(4096, 2) == 256  # clamped to nblocks // 16
    assert pick_encode_chunks(65536, 2) == 512  # honored when it fits
    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "yes")
    with pytest.raises(BjxaInvalidState, match="BJXA_ENCODE_FIXPOINT_CHUNKS"):
        pick_encode_chunks(4096, 2)


def test_pick_encode_chunks_adaptive_default(monkeypatch):
    """Unset env follows FIXPOINT_DEFAULT for the active route."""
    from bjxa_tpu.ops import encode as enc_mod

    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    monkeypatch.setitem(enc_mod.FIXPOINT_DEFAULT, "xla", True)
    assert enc_mod.pick_encode_chunks(4096, 2) == 256
    monkeypatch.setitem(enc_mod.FIXPOINT_DEFAULT, "xla", False)
    assert enc_mod.pick_encode_chunks(4096, 2) == 1


def test_link_rtt_env_override_and_probe(monkeypatch):
    """No run-time probe decides the default any more: choosing the
    chunk count reads no clock."""
    import time

    from bjxa_tpu.ops import encode as enc_mod

    def no_clock():
        raise AssertionError("pick_encode_chunks timed something")

    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    monkeypatch.setattr(time, "perf_counter", no_clock)
    assert enc_mod.pick_encode_chunks(4096, 2) == 1  # cpu: sequential
    assert not hasattr(enc_mod, "link_rtt_us")


def test_fixpoint_default_on_backend_and_link(monkeypatch):
    """The default per platform: the fixpoint on the GPU (measured
    faster there, chip_smoke.py phase encode), sequential on the CPU."""
    import jax

    from bjxa_tpu.ops import encode as enc_mod

    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    assert enc_mod.pick_encode_chunks(4096, 2) == 1
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    want = 256 if enc_mod.FIXPOINT_DEFAULT["triton"] else 1
    assert enc_mod.pick_encode_chunks(4096, 2) == want
    assert enc_mod.pick_encode_chunks(32, 2) == 1  # short-stream floor


def test_segment_threshold_env(monkeypatch):
    from bjxa_tpu.errors import BjxaInvalidState
    from bjxa_tpu.ops.decode import SEGMENT_THRESHOLD, segment_threshold

    monkeypatch.delenv("BJXA_SEGMENT_THRESHOLD", raising=False)
    assert segment_threshold() == SEGMENT_THRESHOLD
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "12345")
    assert segment_threshold() == 12345
    monkeypatch.setenv("BJXA_SEGMENT_THRESHOLD", "huge")
    with pytest.raises(BjxaInvalidState, match="BJXA_SEGMENT_THRESHOLD"):
        segment_threshold()


def test_segmented_encode_fixpoint_byte_identity(monkeypatch):
    """iter_encode_segments with the chunk fixpoint forced on: the
    segmented (search and Kc > 1) branch emits bytes identical to the
    one-shot encoder and carries the search state exactly across
    segments."""
    import io

    from bjxa_tpu.ops.encode import iter_encode_segments

    rng = np.random.default_rng(17)
    nblocks, C = 200, 2
    t = np.linspace(0, 60 * np.pi, nblocks * 32 * C)
    pcm = (
        (11000 * np.sin(t) + rng.integers(-2500, 2500, t.size))
        .astype(np.int16).reshape(-1, C)
    )
    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    want = encode_pcm(pcm, 44100, 6, search=True)
    hdr_len = 32
    body = pcm.astype("<i2").tobytes()

    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "8")
    parts = list(
        iter_encode_segments(
            io.BytesIO(body).read, C, nblocks * 32, bits=6, search=True,
            segment_blocks=128,
        )
    )
    assert b"".join(parts) == want[hdr_len:]


def test_segmented_encode_fixpoint_truncated(monkeypatch):
    """A truncated PCM stream whose final partial segment routes through
    the chunk fixpoint still yields the whole-block prefix and raises
    EOFError (the fixpoint branch's truncation exit)."""
    import io

    from bjxa_tpu.ops.encode import encode_search, iter_encode_segments

    rng = np.random.default_rng(29)
    nblocks, C = 200, 2
    pcm = rng.integers(-20000, 20000, (nblocks * 32, C)).astype(np.int16)
    cut = pcm.astype("<i2").tobytes()[: (150 * 32 + 9) * 2 * C]

    import jax.numpy as jnp

    from bjxa_tpu.ops.deflate import deflate_blocks

    monkeypatch.delenv("BJXA_ENCODE_FIXPOINT_CHUNKS", raising=False)
    # sequential reference over the 150 whole blocks that arrive
    # (128 in segment 1 + 22 in the truncated segment 2)
    sp, sc, _sr, _se = encode_search(
        jnp.asarray(pcm[: 150 * 32].reshape(150, 32, C).astype(np.int32)),
        jnp.zeros((C, 2), jnp.int32),
        bits=6,
    )
    want = np.asarray(
        deflate_blocks(sp, sc.transpose(0, 2, 1), 6)
    ).tobytes()

    monkeypatch.setenv("BJXA_ENCODE_FIXPOINT_CHUNKS", "8")
    got = []
    with pytest.raises(EOFError):
        for part in iter_encode_segments(
            io.BytesIO(cut).read, C, nblocks * 32, bits=6, search=True,
            segment_blocks=128,
        ):
            got.append(part)
    assert b"".join(got) == want

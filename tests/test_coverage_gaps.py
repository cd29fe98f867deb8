"""Targeted tests for branches the main suites leave dark.

The reference's bar is tooled 100% library coverage (README.rst:166,
lcov.am); these tests close the measured gaps of coverage.json — CLI
error paths, native build-failure degradation, writer-thread failure
handling, tile-picker arms, and device-layout helpers — so every
remaining exclusion is an explicit ``pragma: no cover`` with a reason.
"""

import contextlib
import io
import os
import pathlib

import numpy as np
import pytest

from bjxa_tpu import cli


def run_cli(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = cli.main(["bjxa", *args])
    return code, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# CLI option error paths
# ---------------------------------------------------------------------------


class TestCliEncodeArgs:
    def test_bits_missing_value(self):
        code, _, err = run_cli("encode", "--bits")
        assert code == 1 and "Missing number of bits" in err

    def test_bits_not_a_number(self):
        code, _, err = run_cli("encode", "--bits", "six")
        assert code == 1 and "Invalid number of bits" in err

    def test_bits_out_of_range(self):
        code, _, err = run_cli("encode", "--bits", "7")
        assert code == 1 and "Invalid number of bits" in err

    def test_too_many_arguments(self):
        code, _, err = run_cli("encode", "a", "b", "c")
        assert code == 1 and "Too many arguments" in err

    def test_unwritable_output(self, tmp_path):
        src = tmp_path / "in.wav"
        src.write_bytes(b"")
        code, _, err = run_cli(
            "encode", str(src), str(tmp_path / "nodir" / "out.xa")
        )
        assert code == 1 and "Error" in err

    def test_encode_stream_error_label(self, tmp_path):
        # valid RIFF header promising zero samples -> bjxa_encode_init
        # rejects (EPROTO), after the header was already consumed
        from bjxa_tpu.format import dump_riff_header

        src = tmp_path / "empty.wav"
        src.write_bytes(dump_riff_header(0, 44100, 1))
        code, _, err = run_cli("encode", str(src), str(tmp_path / "o.xa"))
        assert code == 1 and "bjxa_encode" in err


class TestCliCorpusArgs:
    def test_bad_batch_files(self):
        code, _, err = run_cli("corpus", "--batch-files", "zero", "a", "b")
        assert code == 1 and "Invalid --batch-files" in err

    def test_missing_manifest(self):
        code, _, err = run_cli("corpus", "--manifest")
        assert code == 1 and "Missing manifest path" in err

    def test_bits_without_encode(self, tmp_path):
        code, _, err = run_cli(
            "corpus", "--bits", "6", str(tmp_path), str(tmp_path)
        )
        assert code == 1 and "--bits/--truncate require --encode" in err

    def test_truncate_without_encode(self, tmp_path):
        code, _, err = run_cli(
            "corpus", "--truncate", str(tmp_path), str(tmp_path)
        )
        assert code == 1 and "require --encode" in err

    def test_bad_bits(self):
        code, _, err = run_cli("corpus", "--bits", "5", "a", "b")
        assert code == 1 and "Invalid number of bits" in err

    def test_missing_coordinator(self):
        code, _, err = run_cli("corpus", "--coordinator")
        assert code == 1 and "Missing coordinator address" in err

    def test_bad_num_processes(self):
        code, _, err = run_cli("corpus", "--num-processes", "0", "a", "b")
        assert code == 1 and "Invalid --num-processes" in err

    def test_bad_process_id(self):
        code, _, err = run_cli("corpus", "--process-id", "x", "a", "b")
        assert code == 1 and "Invalid --process-id" in err

    def test_missing_trace_dir(self):
        code, _, err = run_cli("corpus", "--trace")
        assert code == 1 and "Missing trace directory" in err

    def test_unknown_option(self):
        code, _, err = run_cli("corpus", "--bogus", "a", "b")
        assert code == 1 and "Unknown option" in err

    def test_wrong_arg_count(self):
        code, _, err = run_cli("corpus", "onlyone")
        assert code == 1 and "input and an output directory" in err

    def test_not_a_directory(self, tmp_path):
        f = tmp_path / "plain"
        f.write_bytes(b"")
        code, _, err = run_cli("corpus", str(f), str(tmp_path / "out"))
        assert code == 1 and "Not a directory" in err

    def test_inconsistent_process_flags(self, tmp_path):
        (tmp_path / "in").mkdir()
        code, _, err = run_cli(
            "corpus",
            "--process-id",
            "3",
            "--num-processes",
            "2",
            str(tmp_path / "in"),
            str(tmp_path / "out"),
        )
        assert code == 1

    def test_corpus_oserror(self, tmp_path):
        (tmp_path / "in").mkdir()
        blocker = tmp_path / "out"
        blocker.write_bytes(b"")  # out_dir path exists as a FILE
        code, _, err = run_cli(
            "corpus", str(tmp_path / "in"), str(blocker)
        )
        assert code == 1 and "corpus:" in err


class TestCliEnvKnobs:
    def test_compile_cache_disabled(self, monkeypatch):
        """JAX_COMPILATION_CACHE_DIR set: the code sets no directory of
        its own; unset: the fixed in-checkout directory, which git
        ignores."""
        import jax

        from bjxa_tpu.utils import compile_cache

        calls = {}
        monkeypatch.setattr(
            jax.config, "update", lambda k, v: calls.__setitem__(k, v)
        )
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert compile_cache.enable_compile_cache() == "/elsewhere"
        assert "jax_compilation_cache_dir" not in calls
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        where = compile_cache.enable_compile_cache()
        repo = pathlib.Path(compile_cache.__file__).resolve().parents[2]
        assert where == str(repo / ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == where
        assert ".jax_cache/" in (repo / ".gitignore").read_text().split()

    def test_platform_override(self, monkeypatch):
        """BJXA_PLATFORM reaches jax.config; a failed update is not
        swallowed."""
        import jax

        seen = []
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: seen.append((k, v)))
        monkeypatch.setenv("BJXA_PLATFORM", "cpu")
        cli._select_platform()
        assert seen == [("jax_platforms", "cpu")]

        def refuse(k, v):
            raise RuntimeError("backend already initialised")

        monkeypatch.setattr(jax.config, "update", refuse)
        with pytest.raises(RuntimeError):
            cli._select_platform()


# ---------------------------------------------------------------------------
# native library degradation
# ---------------------------------------------------------------------------


@pytest.fixture
def native_reset():
    from bjxa_tpu import native

    so, lib, tried = native._SO, native._lib, native._tried
    yield native
    native._SO, native._lib, native._tried = so, lib, tried


class TestNativeFallback:
    def test_compile_failure_degrades(self, native_reset, tmp_path,
                                      monkeypatch):
        native = native_reset
        monkeypatch.setenv("CXX", "/bin/false")
        native._SO = tmp_path / "never-built.so"
        native._lib, native._tried = None, False
        assert native.lib() is None
        assert not native.available()

    def test_bad_shared_object_degrades(self, native_reset, tmp_path):
        native = native_reset
        bad = tmp_path / "bad.so"
        bad.write_bytes(b"definitely not ELF")
        native._SO = bad
        native._lib, native._tried = None, False
        assert native.lib() is None

    def test_decode_rejects_bad_bits(self, native_reset):
        native = native_reset
        native._lib, native._tried = None, False
        if not native.available():
            pytest.skip("no native toolchain")
        blocks = np.zeros((1, 1, 21), np.uint8)
        state = np.zeros((1, 2), np.int32)
        with pytest.raises(RuntimeError):
            native.decode_blocks(blocks, 5, state)

    def test_encode_rejects_bad_bits(self, native_reset):
        native = native_reset
        native._lib, native._tried = None, False
        if not native.available():
            pytest.skip("no native toolchain")
        pcm = np.zeros((32, 1), np.int16)
        with pytest.raises(RuntimeError):
            native.encode_blocks(pcm, 5, np.zeros((1, 2), np.int32),
                                 search=False)


# ---------------------------------------------------------------------------
# corpus writer-thread failure handling
# ---------------------------------------------------------------------------


class TestSerialWriter:
    def test_job_failure_surfaces_at_next_put(self):
        from bjxa_tpu.parallel.corpus import _SerialWriter

        def boom():
            raise RuntimeError("disk on fire")

        with pytest.raises(RuntimeError, match="disk on fire"):
            with _SerialWriter(depth=1) as w:
                w.put(boom)
                import time

                time.sleep(0.05)
                w.put(boom)  # raises the stored exception here

    def test_job_failure_surfaces_at_exit(self):
        from bjxa_tpu.parallel.corpus import _SerialWriter

        def boom():
            raise RuntimeError("late failure")

        with pytest.raises(RuntimeError, match="late failure"):
            with _SerialWriter() as w:
                w.put(boom)

    def test_producer_exception_discards_backlog(self):
        from bjxa_tpu.parallel.corpus import _SerialWriter

        ran = []
        with pytest.raises(KeyboardInterrupt):
            with _SerialWriter(depth=2) as w:
                import threading

                gate = threading.Event()
                w.put(gate.wait)  # wedge the worker
                w.put(ran.append, 1)  # backlog that must NOT run
                gate.set()
                raise KeyboardInterrupt
        # the backlog job may or may not have been dequeued before the
        # abort flag was seen, but it must never execute after __exit__
        assert ran == []

    def test_write_batch_oserror_degrades_per_file(self, tmp_path):
        from bjxa_tpu.api import encode_pcm
        from bjxa_tpu.parallel.corpus import decode_corpus

        src = tmp_path / "xa"
        src.mkdir()
        sig = (np.arange(64, dtype=np.int16) * 100).reshape(-1, 1)
        (src / "a.xa").write_bytes(encode_pcm(sig, 44100, 8, search=False))
        out = tmp_path / "out"
        out.mkdir()
        # a DIRECTORY squatting on the temp-file path forces an OSError
        # in write_batch regardless of uid (chmod can't stop root)
        (out / "a.wav.tmp").mkdir()
        res = decode_corpus(src, out, manifest_path=tmp_path / "m.jsonl")
        assert res.converted == 0
        assert list(res.failed) and "a.xa" in next(iter(res.failed))


# ---------------------------------------------------------------------------
# device-layout helpers and tile pickers (pure functions)
# ---------------------------------------------------------------------------


class TestPureHelpers:
    def test_decode_pick_tiles_arms(self):
        """Widest lane tile that still launches MIN_PROGRAMS programs."""
        from bjxa_tpu.ops.pallas_decode import MIN_PROGRAMS, pick_lane_tile

        assert pick_lane_tile(32768) == 64  # 512 programs, not 256
        assert pick_lane_tile(128 * MIN_PROGRAMS) == 128
        assert pick_lane_tile(128 * (MIN_PROGRAMS - 1)) == 64
        assert pick_lane_tile(64 * (MIN_PROGRAMS - 1)) == 32
        assert pick_lane_tile(8192) == 32
        assert pick_lane_tile(1) == 32

    def test_encode_pick_tiles_arms(self):
        """The encode kernel's fixed [16 ranges, 8 lanes] tile and its
        launch grid: one program per 8 lanes, ragged tail masked."""
        from bjxa_tpu.ops import pallas_encode

        assert pallas_encode.LANE_TILE == 8
        assert pallas_encode.NUM_WARPS * 32 * 4 == (
            16 * pallas_encode.LANE_TILE
        )  # 4 candidates per thread

    def test_trim_padded_lanes(self):
        """The GPU kernels return flat, unpadded [B, 32, L] PCM for any
        lane count: nothing is left for hosts to trim (interpret mode)."""
        import jax.numpy as jnp

        from bjxa_tpu.ops.pallas_decode import decode_words

        for L in (1, 33, 70):
            prof = jnp.zeros((3, L), jnp.uint8)
            words = jnp.zeros((3, 4, L), jnp.int32)
            pcm, end = decode_words(prof, words, jnp.zeros((L, 2), jnp.int32),
                                    bits=4, interpret=True)
            assert pcm.shape == (3, 32, L) and end.shape == (L, 2)

    def test_mesh_defaults(self):
        import jax

        from bjxa_tpu.parallel.mesh import dp_sharding, make_mesh

        mesh = make_mesh()  # all devices, dp = n
        assert mesh.shape["dp"] * mesh.shape["sp"] == len(jax.devices())
        sh = dp_sharding(mesh, 3)
        assert sh.spec[0] == "dp"

    def test_filter_env_overrides(self, monkeypatch):
        """One route per platform, no environment override, and an
        unknown platform is an error rather than a silent fallback."""
        import jax

        from bjxa_tpu.ops.filter import kernel_route

        assert kernel_route() == "xla"
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert kernel_route() == "triton"
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(RuntimeError, match="no kernel route"):
            kernel_route()

    def test_decode_lanes_int32_samples(self):
        import jax.numpy as jnp

        from bjxa_tpu.ops.filter import decode_lanes

        profiles = jnp.zeros((2, 1), jnp.int32)
        samples = jnp.ones((2, 32, 1), jnp.int32) << 8
        state = jnp.zeros((1, 2), jnp.int32)
        pcm, end, valid = decode_lanes(profiles, samples, state)
        assert pcm.dtype == jnp.int16 and bool(valid.all())


class TestDecodeBytesBranches:
    def test_scan_path_bucketed(self):
        """parallel=False with B > 64 exercises the scan-path padding."""
        from bjxa_tpu.api import encode_pcm
        from bjxa_tpu.format import XA_HEADER_SIZE, parse_xa_header
        from bjxa_tpu.ops.decode import decode_bytes

        rng = np.random.default_rng(5)
        sig = rng.integers(-2000, 2000, size=(100 * 32, 1)).astype(np.int16)
        xa = encode_pcm(sig, 44100, 8, search=False)
        fmt = parse_xa_header(xa)
        payload = xa[XA_HEADER_SIZE:]
        a = decode_bytes(payload, fmt, parallel=True)
        b = decode_bytes(payload, fmt, parallel=False)
        assert (a == b).all()

    def test_riff_bad_byte_rate(self):
        from bjxa_tpu.errors import BjxaProtocolError
        from bjxa_tpu.format import dump_riff_header, parse_riff_header

        hdr = bytearray(dump_riff_header(64, 44100, 1))
        hdr[28:32] = (12345).to_bytes(4, "little")  # byte_rate field
        with pytest.raises(BjxaProtocolError, match="byte rate"):
            parse_riff_header(bytes(hdr))


# ---------------------------------------------------------------------------
# codec success paths and remaining branches
# ---------------------------------------------------------------------------


class TestCodecPaths:
    def test_read_header_and_streaming_roundtrip(self, tmp_path):
        from bjxa_tpu.api import encode_pcm
        from bjxa_tpu.codec import Decoder

        sig = (np.arange(64, dtype=np.int16) * 50).reshape(-1, 2)
        xa = encode_pcm(sig, 44100, 6, search=False)
        dec = Decoder()
        assert dec.read_header(io.BytesIO(xa)) == 32

    def test_write_pcm_and_header_success(self, tmp_path):
        from bjxa_tpu.codec import Decoder, Encoder
        from bjxa_tpu.format.riff import RiffFormat

        out = tmp_path / "x.bin"
        with open(out, "wb") as f:
            Decoder.write_pcm(np.zeros((4, 2), np.int16), f)
        assert out.read_bytes() == bytes(16)
        enc = Encoder()
        enc.init(
            RiffFormat(data_len_pcm=64, samples_rate=44100, channels=1), 6
        )
        with open(out, "wb") as f:
            assert enc.write_header(f) == 32
        assert out.read_bytes().startswith(b"KWD1")

    def test_read_riff_header_success(self):
        from bjxa_tpu.codec import Encoder
        from bjxa_tpu.format import dump_riff_header

        enc = Encoder()
        hdr = dump_riff_header(64, 44100, 1)
        assert enc.read_riff_header(io.BytesIO(hdr), 6) == 44

    def test_decode_invalid_first_block_numpy_path(self, monkeypatch):
        """First block invalid on the numpy fallback: zero frames emitted,
        protocol error raised, state untouched."""
        from bjxa_tpu import native
        from bjxa_tpu.api import encode_pcm
        from bjxa_tpu.codec import Decoder
        from bjxa_tpu.errors import BjxaProtocolError

        monkeypatch.setenv("BJXA_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        sig = (np.arange(64, dtype=np.int16) * 10).reshape(-1, 1)
        xa = bytearray(encode_pcm(sig, 44100, 8, search=False))
        xa[32] = 0xFF  # invalid factor, first block
        dec = Decoder()
        dec.parse_header(bytes(xa[:32]))
        with pytest.raises(BjxaProtocolError):
            dec.decode(bytes(xa[32:]))


class TestCliRemainingBranches:
    def test_encode_truncate_flag(self, tmp_path):
        from bjxa_tpu.format import dump_pcm, dump_riff_header

        sig = (np.arange(64, dtype=np.int16) * 7).reshape(-1, 1)
        wav = tmp_path / "s.wav"
        wav.write_bytes(dump_riff_header(128, 44100, 1) + dump_pcm(sig))
        out = tmp_path / "s.xa"
        code, _, err = run_cli("encode", "--truncate", str(wav), str(out))
        assert code == 0, err
        assert out.read_bytes()[:4] == b"KWD1"

    def test_encode_unknown_flag_falls_through(self, tmp_path):
        # an unknown --option is treated as a (bad) filename, matching the
        # reference CLI's positional handling
        code, _, err = run_cli("encode", "--bogus")
        assert code == 1

    def test_corpus_valid_batch_files(self, tmp_path):
        from bjxa_tpu.api import encode_pcm

        src = tmp_path / "xa"
        src.mkdir()
        sig = (np.arange(64, dtype=np.int16) * 9).reshape(-1, 1)
        (src / "a.xa").write_bytes(encode_pcm(sig, 44100, 6, search=False))
        code, out, err = run_cli(
            "corpus", "--batch-files", "2",
            str(src), str(tmp_path / "wav"),
        )
        assert code == 0, err
        assert "converted 1" in out


class TestRemainingSmallBranches:
    def test_riff_partial_trailing_frame(self):
        from bjxa_tpu.errors import BjxaProtocolError
        from bjxa_tpu.format import dump_riff_header, parse_riff_header

        hdr = bytearray(dump_riff_header(64, 44100, 2))
        hdr[40:44] = (65).to_bytes(4, "little")  # data_len % frame != 0
        hdr[4:8] = (65 + 36).to_bytes(4, "little")
        with pytest.raises(BjxaProtocolError, match="partial trailing"):
            parse_riff_header(bytes(hdr))

    def test_process_info_fallback(self, monkeypatch):
        import jax

        from bjxa_tpu.parallel.distributed import process_info

        def boom():
            raise RuntimeError("no runtime")

        monkeypatch.setattr(jax, "process_index", boom)
        assert process_info() == (0, 1)

    def test_encode_corpus_default_manifest_and_oserror(self, tmp_path):
        from bjxa_tpu.format import dump_pcm, dump_riff_header
        from bjxa_tpu.parallel.corpus import encode_corpus

        src = tmp_path / "wav"
        src.mkdir()
        sig = (np.arange(64, dtype=np.int16) * 3).reshape(-1, 1)
        (src / "a.wav").write_bytes(
            dump_riff_header(128, 44100, 1) + dump_pcm(sig)
        )
        out = tmp_path / "xa"
        out.mkdir()
        (out / "a.xa.tmp").mkdir()  # squat: forces per-file OSError
        res = encode_corpus(src, out, bits=6, search=False)  # default manifest
        assert res.converted == 0 and list(res.failed)

    def test_mesh_encode_truncate_branch(self):
        import jax

        from bjxa_tpu.parallel.mesh import make_mesh
        from bjxa_tpu.parallel.sharded import encode_corpus_sharded_lanes

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        mesh = make_mesh(jax.devices(), dp=8, sp=1)
        pcm = np.zeros((4, 32, 8), np.int16)
        states = np.zeros((8, 2), np.int32)
        blocks = encode_corpus_sharded_lanes(
            pcm, states, bits=6, search=False, mesh=mesh
        )
        assert np.asarray(blocks).shape == (4, 8, 25)


class TestCorpusDepthFlag:
    def test_depth_flag_parses_and_runs(self, tmp_path):
        from bjxa_tpu.api import encode_pcm

        src = tmp_path / "xa"
        src.mkdir()
        sig = (np.arange(64, dtype=np.int16) * 11).reshape(-1, 1)
        (src / "a.xa").write_bytes(encode_pcm(sig, 44100, 6, search=False))
        code, out, err = run_cli(
            "corpus", "--depth", "1",
            str(src), str(tmp_path / "wav"),
        )
        assert code == 0, err
        assert "converted 1" in out

    def test_bad_depth(self):
        code, _, err = run_cli("corpus", "--depth", "0", "a", "b")
        assert code == 1 and "Invalid --depth" in err

    def test_depth_one_matches_default(self, tmp_path):
        """Pipeline depth changes scheduling only, never bytes."""
        from bjxa_tpu.api import encode_pcm
        from bjxa_tpu.parallel.corpus import decode_corpus

        rng = np.random.default_rng(21)
        src = tmp_path / "xa"
        src.mkdir()
        for i in range(5):
            sig = rng.integers(
                -20000, 20000, size=(37 * 32 + i, 2)
            ).astype(np.int16)
            (src / f"f{i}.xa").write_bytes(
                encode_pcm(sig, 44100, 8, search=False)
            )
        out1, out2 = tmp_path / "o1", tmp_path / "o2"
        r1 = decode_corpus(src, out1, batch_files=2, depth=1,
                           manifest_path=tmp_path / "m1.jsonl")
        r2 = decode_corpus(src, out2, batch_files=2, depth=4,
                           manifest_path=tmp_path / "m2.jsonl")
        assert r1.converted == r2.converted == 5
        for i in range(5):
            assert (out1 / f"f{i}.wav").read_bytes() == (
                out2 / f"f{i}.wav"
            ).read_bytes()


# ---------------------------------------------------------------------------
# C ABI library degradation (native/abi.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def abi_reset():
    from bjxa_tpu.native import abi

    so, lib, tried = abi._SO, abi._lib, abi._tried
    yield abi
    abi._SO, abi._lib, abi._tried = so, lib, tried


class TestAbiFallback:
    def test_no_native_env_disables(self, abi_reset, monkeypatch):
        abi = abi_reset
        monkeypatch.setenv("BJXA_NO_NATIVE", "1")
        abi._lib, abi._tried = None, False
        assert abi.lib() is None
        assert not abi.available()

    def test_compile_failure_degrades(self, abi_reset, tmp_path, monkeypatch):
        abi = abi_reset
        monkeypatch.setenv("CXX", "/bin/false")
        abi._SO = tmp_path / "never-built.so"
        abi._lib, abi._tried = None, False
        assert abi.lib() is None

    def test_bad_shared_object_degrades(self, abi_reset, tmp_path):
        abi = abi_reset
        bad = tmp_path / "bad.so"
        bad.write_bytes(b"definitely not ELF")
        abi._SO = bad
        abi._lib, abi._tried = None, False
        assert abi.lib() is None

    def test_install_without_toolchain_raises(self, abi_reset, tmp_path,
                                              monkeypatch):
        abi = abi_reset
        monkeypatch.setenv("BJXA_NO_NATIVE", "1")
        abi._lib, abi._tried = None, False
        with pytest.raises(RuntimeError, match="unavailable"):
            abi.install(tmp_path / "prefix")

    def test_install_twice_is_idempotent(self, abi_reset, tmp_path):
        abi = abi_reset
        abi._lib, abi._tried = None, False
        if not abi.available():
            pytest.skip("no native toolchain")
        first = abi.install(tmp_path / "p")
        second = abi.install(tmp_path / "p")
        assert first["link"].resolve() == second["link"].resolve()
        assert abi.so_path().exists()

    def test_cli_path_without_lib(self, abi_reset, monkeypatch):
        abi = abi_reset
        monkeypatch.setenv("BJXA_NO_NATIVE", "1")
        abi._lib, abi._tried = None, False
        assert abi.cli_path() is None

    def test_cli_path_compile_failure(self, abi_reset, tmp_path,
                                      monkeypatch):
        abi = abi_reset
        if abi.lib() is None:
            pytest.skip("no native toolchain")
        monkeypatch.setenv("CC", "/bin/false")
        cli = abi._CLI
        abi._CLI = tmp_path / "never-built"
        try:
            assert abi.cli_path() is None
        finally:
            abi._CLI = cli

    def test_cold_build_compiles_fresh(self, abi_reset, tmp_path):
        """Force a from-scratch compile of both the library and the CLI
        binary into a temp build dir (the on-disk .so is normally cached,
        leaving the successful-compile tails unexecuted)."""
        abi = abi_reset
        if abi.lib() is None:
            pytest.skip("no native toolchain")
        build = tmp_path / "fresh"
        build.mkdir()
        so, cli, bdir = abi._SO, abi._CLI, abi._BUILD_DIR
        abi._SO = build / "libbjxa.so"
        abi._CLI = build / "bjxa"
        abi._BUILD_DIR = build
        abi._lib, abi._tried = None, False
        try:
            assert abi.lib() is not None
            assert abi._SO.exists()
            exe = abi.cli_path()
            assert exe is not None and exe.exists()
        finally:
            abi._SO, abi._CLI, abi._BUILD_DIR = so, cli, bdir
            abi._lib, abi._tried = None, False

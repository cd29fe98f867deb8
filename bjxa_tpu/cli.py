"""The ``bjxa`` command-line tool, device edition.

Same surface as the reference CLI (``src/bjxa.c:36-52``): ``help``,
``decode [<xa> [<wav>]]``, ``encode [--bits <4|6|8>] [<wav> [<xa>]]``, with
``-`` or omitted filenames meaning stdin/stdout.  Error labels keep the
reference's perror style (``<failing stage>: <strerror>``) so scripted
callers and the ported test-suite greps keep working.

Extensions over the reference:

* ``encode --truncate`` reproduces the reference's truncation-only encoder
  byte-for-byte; the default runs the full filter-profile search (better
  SNR at identical bitrate).
* ``decode --streaming`` exercises the incremental block-at-a-time codec
  instead of the whole-file device pipeline (both produce identical bytes;
  the reference proves the same property with its BJXA_SINGLE_PASS builds).
* ``abi --install <prefix>`` installs the drop-in libbjxa-compatible C
  library + header + pkg-config file (see ``native/abi.py``).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from bjxa_tpu.errors import BjxaError, BjxaProtocolError
from bjxa_tpu.format import (
    XA_HEADER_SIZE,
    dump_pcm,
    dump_riff_header,
    load_pcm,
    parse_riff_header,
    parse_xa_header,
)
from bjxa_tpu.format.riff import RIFF_HEADER_SIZE

USAGE = """Usage: {prog} <action> [args...]

Available actions:

  help
    Show this message and exit.

  decode [--streaming] [--devices <n>] [--segment-blocks <n>]
         [<xa file> [<wav file>]]
    Read an XA file and convert it into a WAV file.
    Long streams shard their block range across all
    local devices (sequence parallel); --devices caps
    the device count (BJXA_DEVICES env equivalent;
    1 forces single-device).  Files whose payload + PCM
    exceed 256 MB stream through the device in bounded-
    memory segments; --segment-blocks forces segmented
    decode with the given segment size.

  encode [--bits <4|6|8>] [--truncate] [--devices <n>]
         [--segment-blocks <n>] [<wav file> [<xa file>]]
    Read a WAV file and convert it into an XA file.
    The default number of bits per sample, when left
    unspecified is 6. --truncate disables the filter
    profile search (reference-compatible output).
    Long streams shard the search's block range across
    all local devices (sequence parallel); --devices
    caps the device count (BJXA_DEVICES env equivalent;
    1 forces single-device).
    Files whose PCM exceeds 256 MB stream through the
    device in bounded-memory segments (exact carried
    search state); --segment-blocks forces it.

  abi --install <prefix>
    Build the drop-in libbjxa-compatible C library
    (the reference's 19 versioned symbols backed by
    this engine) and install lib/libbjxa.so.0,
    include/bjxa.h and lib/pkgconfig/bjxa.pc under
    <prefix>, ready for `cc app.c $(pkg-config
    --cflags --libs bjxa)`.

  corpus [--batch-files <n>] [--depth <k>] [--manifest <path>]
         [--devices <n>] <xa dir> <wav dir>
    Decode every *.xa file in a directory to WAV files,
    batched on the device, restartable via a JSONL
    manifest (reruns skip already-converted files).
    On a multi-device host the file/channel lanes of
    every batch shard across all local devices (data
    parallel); --devices caps the device count
    (BJXA_DEVICES env equivalent; 1 forces one device).
    --depth bounds in-flight device batches and the
    host write backlog (default 3).
    With --encode (plus optional --bits/--truncate) the
    direction reverses: every *.wav encodes to XA.
    Multi-host: --coordinator <host:port> --num-processes
    <n> --process-id <i> (or BJXA_COORDINATOR /
    BJXA_NUM_PROCESSES / BJXA_PROCESS_ID) shard the file
    list across cooperating processes; the summary line
    reports cross-host totals. --trace <dir> captures a
    jax.profiler trace; --stats prints throughput rates.
"""


def _mesh_devices(devices_opt: int | None):
    """Resolve the local device list for CLI auto-meshing.

    ``devices_opt`` (the --devices flag) falls back to ``BJXA_DEVICES``;
    unset means all local devices.  Local (not global) devices so that
    under ``jax.distributed`` each process meshes only the chips it owns
    — multi-process sharding stays at the file-list level.

    Returns the device list, or None when only one device would be used
    (single-device paths skip shard_map entirely).
    """
    import jax

    n = devices_opt
    source = "--devices"
    if n is None:
        env = os.environ.get("BJXA_DEVICES")
        if env:
            source = "BJXA_DEVICES"
            try:
                n = int(env)
            except ValueError:
                raise ValueError(f"Invalid BJXA_DEVICES {env!r}")
    devs = jax.local_devices()
    if n is not None:
        if n < 1 or n > len(devs):
            raise ValueError(
                f"{source} {n} out of range (1..{len(devs)} available)"
            )
        devs = devs[:n]
    return devs if len(devs) > 1 else None


def _dp_mesh(devices_opt: int | None):
    """Data-parallel mesh over the local devices (corpus lane sharding),
    or None for single-device runs."""
    devs = _mesh_devices(devices_opt)
    if devs is None:
        return None
    from bjxa_tpu.parallel.mesh import make_mesh

    return make_mesh(devs, dp=len(devs), sp=1)


def _sp_mesh(devices_opt: int | None):
    """Sequence-parallel mesh over the local devices (long-stream block
    sharding), or None for single-device runs."""
    devs = _mesh_devices(devices_opt)
    if devs is None:
        return None
    from bjxa_tpu.parallel.mesh import make_mesh

    return make_mesh(devs, dp=len(devs), sp=1, axis_names=("sp", "_"))


def _usage(prog: str, file) -> None:
    file.write(USAGE.format(prog=prog))


def _fail(prog: str, msg: str) -> int:
    sys.stderr.write(f"bjxa: {msg}\n")
    _usage(prog, sys.stderr)
    return 1


def _perror(label: str, exc: BjxaError | OSError) -> None:
    err = getattr(exc, "errno", None) or 0
    text = os.strerror(err) if err else str(exc)
    sys.stderr.write(f"{label}: {text}\n")


def _open_input(path: str | None):
    if path is None or path == "-":
        return sys.stdin.buffer, False
    return open(path, "rb"), True


def _open_output(path: str | None):
    if path is None or path == "-":
        return sys.stdout.buffer, False
    return open(path, "wb"), True


def _cmd_decode(args: list[str], prog: str) -> int:
    streaming = False
    devices = None
    segment_blocks = None
    while args and args[0].startswith("--"):
        if args[0] == "--streaming":
            streaming = True
            args = args[1:]
        elif args[0] == "--devices":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --devices")
            devices = int(args[1])
            args = args[2:]
        elif args[0] == "--segment-blocks":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --segment-blocks")
            segment_blocks = int(args[1])
            args = args[2:]
        else:
            break
    if len(args) > 2:
        return _fail(prog, "Too many arguments")

    try:
        fin, close_in = _open_input(args[0] if len(args) > 0 else None)
    except OSError as e:
        _perror("Error", e)
        return 1
    try:
        fout, close_out = _open_output(args[1] if len(args) > 1 else None)
    except OSError as e:
        _perror("Error", e)
        return 1

    try:
        return _decode_stream(
            fin, fout, streaming, devices=devices,
            segment_blocks=segment_blocks,
        )
    finally:
        if close_in:
            fin.close()
        if close_out:
            fout.close()


def _decode_stream(
    fin, fout, streaming: bool, devices=None, segment_blocks=None
) -> int:
    # An explicit multi-device request (flag or env) validates eagerly —
    # the user asked for devices, so touching the backend is inherent.
    # The default path resolves its mesh lazily, only where device work
    # actually happens: bad-header error paths and `--streaming` (a pure
    # host path) never pay the backend init.
    explicit = devices is not None or bool(os.environ.get("BJXA_DEVICES"))
    sp_mesh = None
    if explicit:
        try:
            sp_mesh = _sp_mesh(devices)
        except ValueError as e:
            sys.stderr.write(f"bjxa: {e}\n")
            return 1
    header = fin.read(XA_HEADER_SIZE)
    if header is None or len(header) < XA_HEADER_SIZE:
        sys.stderr.write("bjxa_fread_header: Input/output error\n")
        return 1
    try:
        fmt = parse_xa_header(header)
    except BjxaError as e:
        _perror("bjxa_fread_header", e)
        return 1

    if streaming:
        fout.write(
            dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
        )
        from bjxa_tpu.codec import Decoder

        dec = Decoder()
        dec.parse_header(header)
        left = fmt.blocks
        while left > 0:
            raw = fin.read(fmt.block_size_xa)
            if raw is None or len(raw) < fmt.block_size_xa:
                sys.stderr.write("fread: End of file\n")
                return 1
            try:
                pcm = dec.decode(raw)
            except BjxaError as e:
                _perror("bjxa_decode", e)
                return 1
            fout.write(dump_pcm(pcm))
            left -= 1
        return 0

    from bjxa_tpu.ops.decode import SEGMENT_BLOCKS, segment_threshold

    if (
        segment_blocks
        or fmt.data_len + fmt.data_len_pcm > segment_threshold()
    ):
        if not explicit:
            sp_mesh = _sp_mesh(None)
        return _decode_segmented(
            fin, fout, fmt, segment_blocks or SEGMENT_BLOCKS,
            mesh=sp_mesh,
        )

    fout.write(
        dump_riff_header(fmt.data_len_pcm, fmt.samples_rate, fmt.channels)
    )
    payload = fin.read(fmt.data_len)
    if payload is None or len(payload) < fmt.data_len:
        return _decode_truncated(fout, payload or b"", fmt)

    from bjxa_tpu.ops.decode import decode_bytes

    if not explicit:
        sp_mesh = _sp_mesh(None)
    try:
        # Long streams shard their block range over the local devices
        # (sequence-parallel ppermute ring, bit-exact); decode_bytes
        # ignores the mesh for short streams and _sp_mesh returns None on
        # single-device hosts, so the default path is unchanged there.
        pcm = decode_bytes(payload, fmt, mesh=sp_mesh)
    except BjxaProtocolError as e:
        # emit the valid prefix, as the reference's block loop does, then
        # report the failure (src/bjxa_decode.c:122-137)
        prefix = _decode_valid_prefix(payload, fmt)
        if prefix is not None and prefix.size:
            fout.write(dump_pcm(prefix))
        _perror("bjxa_decode", e)
        return 1
    fout.write(dump_pcm(pcm))
    return 0


def _decode_segmented(fin, fout, fmt, segment_blocks: int, mesh=None) -> int:
    """Bounded-memory decode loop (``api.decode_xa_stream``): segments
    stream through the device and land on disk as they finish; error
    labels match the one-shot paths (the reference's block loop emits the
    valid prefix before failing, ``src/bjxa_decode.c:122-152``).  On a
    multi-device host each segment shards across the local devices."""
    from bjxa_tpu.api import decode_xa_stream

    try:
        decode_xa_stream(
            fin, fout, fmt, segment_blocks=segment_blocks, mesh=mesh
        )
    except EOFError:
        sys.stderr.write("fread: End of file\n")
        return 1
    except BjxaProtocolError as e:
        _perror("bjxa_decode", e)
        return 1
    return 0


def _decode_truncated(fout, payload, fmt):
    """Short payload: emit the complete effective blocks that did arrive.

    Byte-parity with the reference's streaming loop
    (``src/bjxa_decode.c:122-152``): each complete block present decodes
    and writes before the short ``fread`` fails — and an invalid profile
    inside that prefix fails with the protocol error first.

    Work is capped at the blocks actually present: a reduced format keeps
    memory and compute O(available) even when a corrupt header promises a
    huge (up to u32) ``data_len``, matching the reference's O(block)
    streaming memory rather than materializing the promised stream.
    """
    import dataclasses

    from bjxa_tpu.ops.decode import decode_bytes_validity

    avail = len(payload) // fmt.block_size_xa
    if avail:
        # avail < fmt.blocks always holds here: XAFormat.validate rejects
        # a stereo data_len that is not a whole number of EFFECTIVE
        # blocks (see PARITY.md "Known divergences"), so a short payload
        # can never supply every effective block.  The samples cap below
        # is therefore just belt-and-braces for the general sub-format.
        sub = dataclasses.replace(
            fmt,
            data_len=avail * fmt.block_size_xa,
            samples=min(fmt.samples, avail * 32),
        )
        frames, valid = decode_bytes_validity(payload[: sub.data_len], sub)
        v = np.asarray(valid).all(axis=1)
        first_bad = int(np.argmin(v)) if not v.all() else len(v)
        good = min(first_bad, avail)
        out = np.asarray(frames[: min(good * 32, sub.samples)])
        if out.size:
            fout.write(dump_pcm(out))
        if first_bad < avail:
            _perror("bjxa_decode", BjxaProtocolError("invalid profile"))
            return 1
    sys.stderr.write("fread: End of file\n")
    return 1


def _decode_valid_prefix(payload, fmt):
    """Frames of the effective blocks preceding the first invalid profile.

    Runs through the same block-count-bucketed pipeline as the happy path
    (:func:`bjxa_tpu.ops.decode.decode_bytes_validity`), so a corrupt
    corpus reuses the already-compiled programs instead of compiling a
    fresh exact-shape program per malformed file.
    """
    from bjxa_tpu.ops.decode import decode_bytes_validity

    frames, valid = decode_bytes_validity(payload, fmt)
    v = np.asarray(valid).all(axis=1)
    good = int(np.argmin(v)) if not v.all() else len(v)
    frames = np.asarray(frames[: good * 32])
    limit = fmt.data_len_pcm // (2 * fmt.channels)
    return frames[: min(len(frames), limit)]


def _cmd_encode(args: list[str], prog: str) -> int:
    bits = 6
    search = True
    devices = None
    segment_blocks = None
    while args and args[0].startswith("--"):
        if args[0] == "--bits":
            args = args[1:]
            if not args:
                return _fail(prog, "Missing number of bits per sample")
            try:
                bits = int(args[0])
            except ValueError:
                bits = -1
            if bits not in (4, 6, 8):
                return _fail(prog, "Invalid number of bits per sample")
            args = args[1:]
        elif args[0] == "--truncate":
            search = False
            args = args[1:]
        elif args[0] == "--devices":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --devices")
            devices = int(args[1])
            args = args[2:]
        elif args[0] == "--segment-blocks":
            if len(args) < 2 or not args[1].isdigit() or int(args[1]) < 1:
                return _fail(prog, "Invalid --segment-blocks")
            segment_blocks = int(args[1])
            args = args[2:]
        else:
            break
    if len(args) > 2:
        return _fail(prog, "Too many arguments")

    try:
        fin, close_in = _open_input(args[0] if len(args) > 0 else None)
    except OSError as e:
        _perror("Error", e)
        return 1
    try:
        fout, close_out = _open_output(args[1] if len(args) > 1 else None)
    except OSError as e:
        _perror("Error", e)
        return 1

    try:
        return _encode_stream(
            fin, fout, bits, search, devices=devices,
            segment_blocks=segment_blocks,
        )
    finally:
        if close_in:
            fin.close()
        if close_out:
            fout.close()


def _encode_stream(
    fin, fout, bits: int, search: bool, devices=None, segment_blocks=None
) -> int:
    # Mesh resolution mirrors _decode_stream: an explicit multi-device
    # request (flag or env) validates eagerly; the default path resolves
    # its mesh lazily, only where device work actually happens, so
    # bad-header error paths never pay the backend init.
    explicit = devices is not None or bool(os.environ.get("BJXA_DEVICES"))
    sp_mesh = None
    if explicit:
        try:
            sp_mesh = _sp_mesh(devices)
        except ValueError as e:
            sys.stderr.write(f"bjxa: {e}\n")
            return 1
    header = fin.read(RIFF_HEADER_SIZE)
    if header is None or len(header) < RIFF_HEADER_SIZE:
        sys.stderr.write("bjxa_fread_riff_header: Input/output error\n")
        return 1
    try:
        rf = parse_riff_header(header)
    except BjxaError as e:
        _perror("bjxa_fread_riff_header", e)
        return 1

    from bjxa_tpu.ops.decode import SEGMENT_BLOCKS, segment_threshold

    if segment_blocks or rf.data_len_pcm > segment_threshold():
        if not explicit and search:
            sp_mesh = _sp_mesh(None)
        return _encode_segmented(
            fin, fout, rf, bits, search, segment_blocks or SEGMENT_BLOCKS,
            mesh=sp_mesh,
        )

    body = fin.read(rf.data_len_pcm)
    if body is None or len(body) < rf.data_len_pcm:
        return _encode_truncated(fout, body or b"", rf, bits, search)

    from bjxa_tpu.api import encode_pcm

    if not explicit and search:
        sp_mesh = _sp_mesh(None)
    try:
        # Long streams shard the profile search's block range over the
        # local devices (sequence-parallel ppermute ring, bit-identical
        # to the sequential greedy search); encode_pcm ignores the mesh
        # for short streams and _sp_mesh returns None on single-device
        # hosts, so the default path is unchanged there.
        xa = encode_pcm(
            load_pcm(body, rf.channels), rf.samples_rate, bits,
            search=search, mesh=sp_mesh,
        )
    except BjxaError as e:
        _perror("bjxa_encode", e)
        return 1
    fout.write(xa)
    return 0


def _encode_segmented(
    fin, fout, rf, bits: int, search: bool, segment_blocks: int, mesh=None
) -> int:
    """Bounded-memory encode loop (``api.encode_wav_stream``): segments
    of PCM stream through the device with the search state carried
    exactly, bit-identical to the one-shot encoder (the streaming
    reference loop writes the header before reading blocks,
    ``src/bjxa_encode.c:108-160``).  On a multi-device host each
    segment's search shards across the local devices (ppermute ring)."""
    from bjxa_tpu.api import encode_wav_stream

    try:
        encode_wav_stream(
            fin, fout, bits, search=search, rf=rf,
            segment_blocks=segment_blocks, mesh=mesh,
        )
    except EOFError:
        sys.stderr.write("fread: End of file\n")
        return 1
    return 0


def _encode_truncated(fout, body, rf, bits: int, search: bool) -> int:
    """Short PCM body: write the XA header and the complete blocks that
    did arrive, then fail like the reference's streaming loop
    (``src/bjxa_encode.c:108-160`` writes the header before reading
    blocks, so truncated input still produces a prefix).
    """
    from bjxa_tpu.codec import Encoder
    from bjxa_tpu.errors import BjxaBufferError

    enc = Encoder()
    try:
        enc.init(rf, bits)
    except BjxaError as e:  # pragma: no cover - defensive: a parsed RIFF
        # cannot fail init (XA payload is smaller than its PCM, so the
        # u32 data_len cannot overflow; samples==0 never reaches the
        # truncated branch because an empty body is not a short read)
        _perror("bjxa_encode_init", e)
        return 1
    fout.write(enc.dump_header())
    frame_bytes = 2 * rf.channels
    avail = body[: len(body) // frame_bytes * frame_bytes]
    try:
        fout.write(enc.encode(avail, search=search))
    except BjxaBufferError:
        pass  # not even one whole block arrived
    sys.stderr.write("fread: End of file\n")
    return 1


def _cmd_corpus(args: list[str], prog: str) -> int:
    batch_files = 64
    depth = 3
    manifest = None
    encode = False
    bits = 6
    search = True
    saw_encode_opts = False
    coordinator = None
    num_processes = None
    process_id = None
    trace_dir = None
    stats = False
    devices = None

    def _take_value(args):
        if len(args) < 2:
            return None, args[1:]
        return args[1], args[2:]

    while args and args[0].startswith("--"):
        if args[0] == "--batch-files":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --batch-files")
            batch_files = int(val)
        elif args[0] == "--depth":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --depth")
            depth = int(val)
        elif args[0] == "--manifest":
            val, args = _take_value(args)
            if val is None:
                return _fail(prog, "Missing manifest path")
            manifest = val
        elif args[0] == "--encode":
            encode = True
            args = args[1:]
        elif args[0] == "--bits":
            val, args = _take_value(args)
            if val is None or val not in ("4", "6", "8"):
                return _fail(prog, "Invalid number of bits per sample")
            bits = int(val)
            saw_encode_opts = True
        elif args[0] == "--truncate":
            search = False
            saw_encode_opts = True
            args = args[1:]
        elif args[0] == "--coordinator":
            val, args = _take_value(args)
            if val is None:
                return _fail(prog, "Missing coordinator address")
            coordinator = val
        elif args[0] == "--num-processes":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --num-processes")
            num_processes = int(val)
        elif args[0] == "--process-id":
            val, args = _take_value(args)
            if val is None or not val.isdigit():
                return _fail(prog, "Invalid --process-id")
            process_id = int(val)
        elif args[0] == "--trace":
            val, args = _take_value(args)
            if val is None:
                return _fail(prog, "Missing trace directory")
            trace_dir = val
        elif args[0] == "--stats":
            stats = True
            args = args[1:]
        elif args[0] == "--devices":
            val, args = _take_value(args)
            if val is None or not val.isdigit() or int(val) < 1:
                return _fail(prog, "Invalid --devices")
            devices = int(val)
        else:
            return _fail(prog, f"Unknown option {args[0]}")
    if saw_encode_opts and not encode:
        return _fail(prog, "--bits/--truncate require --encode")
    if len(args) != 2:
        return _fail(prog, "corpus needs an input and an output directory")
    in_dir, out_dir = args
    if not os.path.isdir(in_dir):
        sys.stderr.write(f"corpus: {in_dir}: Not a directory\n")
        return 1

    from bjxa_tpu.parallel import distributed
    from bjxa_tpu.parallel.corpus import decode_corpus, encode_corpus
    from bjxa_tpu.utils.profiler import Profiler

    try:
        distributed.initialize(coordinator, num_processes, process_id)
    except ValueError as e:
        return _fail(prog, str(e))
    try:
        # Auto-mesh: every batch's file/channel lanes shard over all the
        # process's local devices (data parallel, zero communication);
        # single-device hosts get None and the unsharded fast path.
        mesh = _dp_mesh(devices)
    except ValueError as e:
        return _fail(prog, str(e))
    profiler = Profiler(trace_dir)

    try:
        with profiler.trace():
            if encode:
                res = encode_corpus(
                    in_dir,
                    out_dir,
                    bits=bits,
                    search=search,
                    batch_files=batch_files,
                    manifest_path=manifest,
                    mesh=mesh,
                    depth=depth,
                )
            else:
                res = decode_corpus(
                    in_dir,
                    out_dir,
                    batch_files=batch_files,
                    manifest_path=manifest,
                    mesh=mesh,
                    depth=depth,
                )
    except (BjxaError, OSError) as e:
        _perror("corpus", e)
        return 1
    for path, why in sorted(res.failed.items()):
        sys.stderr.write(f"corpus: {path}: {why}\n")

    # Cross-host totals: every process enters the reduction (a collective),
    # the first prints. Single-process runs reduce to the identity.
    converted, skipped, nfailed = distributed.allreduce_sum(
        [res.converted, res.skipped, len(res.failed)]
    )
    counters = distributed.allreduce_counters(res.counters)
    index, _count = distributed.process_info()
    if index == 0:
        sys.stdout.write(
            f"converted {converted} skipped {skipped}"
            f" failed {nfailed}"
            f" samples {counters.samples}\n"
        )
        if stats:
            rates = counters.rates()
            sys.stdout.write(
                "stats"
                f" files_per_s {rates['files_per_s']:.2f}"
                f" msamples_per_s {rates['msamples_per_s']:.2f}"
                f" mb_in_per_s {rates['mb_in_per_s']:.2f}"
                f" mb_out_per_s {rates['mb_out_per_s']:.2f}"
                f" elapsed_s {rates['elapsed_s']:.3f}\n"
            )
    return 1 if res.failed else 0


def _select_platform() -> None:
    """Honor ``BJXA_PLATFORM`` (e.g. ``cpu``) before any backend use.

    An environment override of ``JAX_PLATFORMS`` is read only when jax is
    first imported; the config update works at any point before the first
    backend is built.
    """
    plat = os.environ.get("BJXA_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)


def _cmd_abi(args: list[str], prog: str) -> int:
    """Install the drop-in C ABI (library + header + pkg-config)."""
    if len(args) != 2 or args[0] != "--install":
        return _fail(prog, "abi requires --install <prefix>")
    from bjxa_tpu.native import abi

    try:
        paths = abi.install(args[1])
    except RuntimeError as exc:
        sys.stderr.write(f"abi: {exc}\n")
        return 1
    except OSError as exc:
        _perror("abi", exc)
        return 1
    for role in ("lib", "header", "pkgconfig", "bin"):
        if role in paths:
            sys.stdout.write(f"{role} {paths[role]}\n")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "bjxa"
    args = argv[1:]
    _select_platform()
    from bjxa_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if not args:
        return _fail(prog, "Missing an action")
    action, rest = args[0], args[1:]
    if action == "help":
        _usage(prog, sys.stdout)
        return 0
    if action == "decode":
        return _cmd_decode(rest, prog)
    if action == "encode":
        return _cmd_encode(rest, prog)
    if action == "corpus":
        return _cmd_corpus(rest, prog)
    if action == "abi":
        return _cmd_abi(rest, prog)
    return _fail(prog, "Unknown action")


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of bjxa-tpu on an NVIDIA GPU: the main paths at real size.

Run from the root of a checkout on a host with one GPU::

    python chip_smoke.py                # phases 1-5 on one card
    python chip_smoke.py --four-cards   # phase 6 only, on four cards

Inputs are generated from ``--seed``; every output is compared, byte for
byte, with the repo's native C++ codec (``bjxa_tpu/native``).  Phases:

1. ``long_decode`` — ``bjxa decode`` of a 10-minute 44.1 kHz 8-bit stereo
   XA file (whole-file chunk fixpoint), then again with
   ``--segment-blocks 65536``.
2. ``corpus`` — ``bjxa corpus`` over 64 mixed files (4/6/8-bit, mono and
   stereo, 2 s to 4 min; two with a corrupt profile, one truncated), then
   a second run that must skip every converted file via the manifest,
   then a third into an empty directory (the first run's work, compiled
   programs already loaded).
3. ``encode`` — ``bjxa encode --bits 4|6|8`` (profile search) and
   ``--truncate`` of a 60 s stereo WAV with saturating passages, plus the
   sequential-vs-fixpoint timing behind the encode fixpoint default.
4. ``error_path`` — mid-stream corrupt profiles and a truncated file:
   exit 1 with the reference's message and the valid prefix written.
5. ``kernels`` — each Pallas kernel against the XLA version of the same
   step at ``bench.py``'s shapes: equality, then Msamples/s of both.
6. ``four_cards`` (``--four-cards`` only) — phase 1's decode and phase 3's
   6-bit encode through ``--devices 4`` (the sequence-parallel ring) and
   phase 2's corpus over a 4-card data-parallel mesh, each compared with
   the one-card result and the native reference.

Prints the card's name and power limit, one line per phase, and last one
JSON object ``{"ok": true, "device": {...}}``.  Exits non-zero, without
that line, when JAX finds no GPU, when the package is not beside this
script, or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import platform
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

RATE = 44100
LONG_SECONDS = 600
ENCODE_SECONDS = 60
CORPUS_FILES = 64
CORPUS_SECONDS = (2, 20, 240)
SEGMENT_BLOCKS = 65536


class PhaseError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# --------------------------------------------------------------------------
# inputs, made from the seed
# --------------------------------------------------------------------------


def random_xa(rng, bits: int, channels: int, samples: int,
              state=((0, 0), (0, 0))) -> bytes:
    """An XA file of random payload bytes with random valid profiles."""
    from bjxa_tpu.format import XAFormat, dump_xa_header

    size = 4 * bits + 1
    nblocks = -(-samples // 32)
    body = rng.integers(0, 256, (nblocks * channels, size), dtype=np.uint8)
    body[:, 0] = (
        rng.integers(0, 5, nblocks * channels) << 4
        | rng.integers(0, 13, nblocks * channels)
    ).astype(np.uint8)
    fmt = XAFormat(
        data_len=nblocks * channels * size,
        samples=samples,
        samples_rate=RATE,
        bits=bits,
        channels=channels,
        initial_state=state,
    )
    return dump_xa_header(fmt) + body.tobytes()


def test_signal(rng, seconds: int, channels: int = 2) -> np.ndarray:
    """Tones, noise, and passages driven hard into int16 saturation."""
    n = seconds * RATE
    t = np.arange(n) / RATE
    out = np.empty((n, channels), np.int16)
    for c in range(channels):
        sig = (
            9000 * np.sin(2 * np.pi * (220 + 110 * c) * t)
            + 4000 * np.sin(2 * np.pi * 3150 * t + c)
            + rng.normal(0, 1500, n)
        )
        # every 10 s: 2 s at 4x gain, clipped hard at the int16 rails
        loud = (t % 10) < 2
        sig[loud] *= 4
        out[:, c] = np.clip(sig, -32768, 32767).astype(np.int16)
    return out


def wav_bytes(pcm: np.ndarray) -> bytes:
    from bjxa_tpu.format import dump_pcm, dump_riff_header

    return dump_riff_header(pcm.size * 2, RATE, pcm.shape[1]) + dump_pcm(pcm)


# --------------------------------------------------------------------------
# the native C++ reference
# --------------------------------------------------------------------------


def native_decode(xa: bytes):
    """(header-promised WAV bytes, valid-prefix frames, complete?) of an XA
    file, decoded by the native C++ codec."""
    from bjxa_tpu import native
    from bjxa_tpu.format import XA_HEADER_SIZE, dump_riff_header
    from bjxa_tpu.format import parse_xa_header

    fmt = parse_xa_header(xa[:XA_HEADER_SIZE])
    payload = xa[XA_HEADER_SIZE:XA_HEADER_SIZE + fmt.data_len]
    avail = len(payload) // fmt.block_size_xa
    blocks = np.frombuffer(
        payload, np.uint8, count=avail * fmt.block_size_xa
    ).reshape(avail, fmt.channels, fmt.block_size)
    state = fmt.initial_state_array().copy()
    pcm, done = native.decode_blocks(blocks, fmt.bits, state)
    frames = pcm[: min(done * 32, fmt.samples)]
    header = dump_riff_header(fmt.data_len_pcm, fmt.samples_rate,
                              fmt.channels)
    return header, frames, done == fmt.blocks


def native_encode(pcm: np.ndarray, bits: int, search: bool) -> bytes:
    from bjxa_tpu import native
    from bjxa_tpu.codec import Encoder
    from bjxa_tpu.format import parse_riff_header

    enc = Encoder()
    enc.init(parse_riff_header(wav_bytes(pcm)[:44]), bits)
    frames, channels = pcm.shape
    padded = np.zeros((-(-frames // 32) * 32, channels), np.int16)
    padded[:frames] = pcm
    state = np.zeros((channels, 2), np.int32)
    blocks = native.encode_blocks(padded, bits, state, search=search)
    return enc.dump_header() + blocks.tobytes()


def mismatches(a: bytes, b: bytes) -> int:
    """Differing bytes between two outputs (a length gap counts fully)."""
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, count=n)
    y = np.frombuffer(b, np.uint8, count=n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    err = got.astype(np.float64) - ref
    return float(10 * np.log10(np.sum(ref * ref) / max(np.sum(err * err), 1)))


# --------------------------------------------------------------------------
# the CLI, in this process (one process owns the card)
# --------------------------------------------------------------------------


def bjxa(*args: str):
    """Run ``python -m bjxa_tpu <args>`` in-process; (rc, stdout, stderr)."""
    from bjxa_tpu import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["bjxa", *args])
    return rc, out.getvalue(), err.getvalue()


def timed_bjxa(*args: str):
    t0 = time.perf_counter()
    rc, out, err = bjxa(*args)
    return rc, out, err, time.perf_counter() - t0


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def make_long_xa(tmp: pathlib.Path, seed: int, seconds: int) -> pathlib.Path:
    path = tmp / "long.xa"
    if not path.exists():
        rng = np.random.default_rng(seed)
        path.write_bytes(
            random_xa(rng, 8, 2, seconds * RATE, ((1200, -700), (-30, 45)))
        )
    return path


def phase_long_decode(tmp, seed, seconds=LONG_SECONDS,
                      segment_blocks=SEGMENT_BLOCKS, devices=None):
    xa = make_long_xa(tmp, seed, seconds)
    header, frames, _ = native_decode(xa.read_bytes())
    want = header + frames.astype("<i2").tobytes()
    dev = [] if devices is None else ["--devices", str(devices)]
    fields = {"blocks": len(frames) // 32, "mb_pcm": len(want) / 1e6}
    for name, extra in (("whole", []),
                        ("segmented", ["--segment-blocks",
                                       str(segment_blocks)])):
        out = tmp / f"long-{name}-{devices or 1}.wav"
        rc, _o, err, dt = timed_bjxa("decode", *dev, *extra, str(xa),
                                     str(out))
        check(rc == 0, f"decode {name} rc={rc}: {err.strip()}")
        bad = mismatches(out.read_bytes(), want)
        fields[f"{name}_mismatches"] = bad
        fields[f"{name}_s"] = dt
        check(bad == 0, f"decode {name}: {bad} bytes differ from native")
    return fields


def make_corpus(tmp: pathlib.Path, seed: int, n_files: int, seconds):
    src = tmp / "corpus-xa"
    if src.exists():
        return src, json.loads((tmp / "corpus-bad.json").read_text())
    src.mkdir()
    rng = np.random.default_rng(seed + 1)
    bad = {}
    for i in range(n_files):
        bits = int(rng.choice([4, 6, 8]))
        channels = int(rng.choice([1, 2]))
        samples = int(rng.choice(seconds) * RATE * rng.uniform(1.0, 1.05))
        data = bytearray(random_xa(rng, bits, channels, samples))
        size = (4 * bits + 1) * channels
        nblocks = (len(data) - 32) // size
        if i in (5, 17):  # a corrupt profile factor mid-stream
            blk = int(rng.integers(nblocks // 4, 3 * nblocks // 4))
            data[32 + blk * size] |= 0xF0
            bad[f"f{i:03d}"] = "corrupt"
        elif i == 29:  # cut inside the payload
            data = data[: 32 + (nblocks // 2) * size + 3]
            bad[f"f{i:03d}"] = "truncated"
        (src / f"f{i:03d}.xa").write_bytes(bytes(data))
    (tmp / "corpus-bad.json").write_text(json.dumps(bad))
    return src, bad


def phase_corpus(tmp, seed, n_files=CORPUS_FILES, seconds=CORPUS_SECONDS,
                 devices=None):
    src, bad = make_corpus(tmp, seed, n_files, seconds)
    dst = tmp / f"corpus-wav-{devices or 1}"
    shutil.rmtree(dst, ignore_errors=True)
    dev = [] if devices is None else ["--devices", str(devices)]
    rc, out, err, dt = timed_bjxa("corpus", *dev, str(src), str(dst))
    check(rc == 1, f"corpus rc={rc} (3 bad files must fail): {err[-500:]}")
    good = n_files - len(bad)
    check(out.startswith(f"converted {good} skipped 0 failed {len(bad)}"),
          f"corpus summary: {out.strip()}")
    for stem in bad:
        check(f"{stem}.xa" in err, f"corpus did not report {stem}")
        check(not (dst / f"{stem}.wav").exists(), f"{stem}.wav written")
    bad_bytes = 0
    for path in sorted(src.glob("*.xa")):
        if path.stem in bad:
            continue
        header, frames, full = native_decode(path.read_bytes())
        check(full, f"{path.name}: native decode incomplete")
        bad_bytes += mismatches(
            (dst / f"{path.stem}.wav").read_bytes(),
            header + frames.astype("<i2").tobytes(),
        )
    check(bad_bytes == 0, f"corpus: {bad_bytes} bytes differ from native")
    rc2, out2, err2, dt2 = timed_bjxa("corpus", *dev, str(src), str(dst))
    check(out2.startswith(f"converted 0 skipped {good} failed {len(bad)}"),
          f"corpus rerun: {out2.strip()}")
    # every file again into an empty directory: the same decode work as
    # the first run, with this process's compiled programs already loaded
    warm = tmp / f"corpus-warm-{devices or 1}"
    rc3, out3, err3, dt3 = timed_bjxa("corpus", *dev, str(src), str(warm))
    check(rc3 == 1 and out3.startswith(
        f"converted {good} skipped 0 failed {len(bad)}"),
          f"corpus warm run: {out3.strip()}")
    warm_bytes = sum(
        mismatches(p.read_bytes(), (warm / p.name).read_bytes())
        for p in dst.glob("*.wav")
    )
    check(warm_bytes == 0, f"corpus warm run: {warm_bytes} bytes differ")
    samples = sum(
        int(np.frombuffer(p.read_bytes()[40:44], "<u4")[0]) // 2
        for p in dst.glob("*.wav")
    )
    return {"files": n_files, "good": good, "failed": len(bad),
            "mismatches": bad_bytes, "first_s": dt, "rerun_s": dt2,
            "warm_s": dt3, "msamples": samples / 1e6}


def make_wav(tmp: pathlib.Path, seed: int, seconds: int):
    path = tmp / "music.wav"
    pcm_path = tmp / "music.npy"
    if not path.exists():
        pcm = test_signal(np.random.default_rng(seed + 2), seconds)
        path.write_bytes(wav_bytes(pcm))
        np.save(pcm_path, pcm)
    return path, np.load(pcm_path)


def phase_encode(tmp, seed, seconds=ENCODE_SECONDS, devices=None,
                 bits_list=(4, 6, 8), truncate=True, fixpoint=True):
    wav, pcm = make_wav(tmp, seed, seconds)
    dev = [] if devices is None else ["--devices", str(devices)]
    fields = {"frames": len(pcm)}
    runs = [(b, True) for b in bits_list] + ([(6, False)] if truncate else [])
    for bits, search in runs:
        name = f"{bits}{'' if search else 't'}"
        out = tmp / f"music-{name}-{devices or 1}.xa"
        mode = [] if search else ["--truncate"]
        rc, _o, err, dt = timed_bjxa("encode", *dev, "--bits", str(bits),
                                     *mode, str(wav), str(out))
        check(rc == 0, f"encode {name} rc={rc}: {err.strip()}")
        got = out.read_bytes()
        bad = mismatches(got, native_encode(pcm, bits, search))
        check(bad == 0, f"encode {name}: {bad} bytes differ from native")
        _h, back, _full = native_decode(got)
        check(len(back) == len(pcm), f"encode {name}: decoded length")
        fields[f"{name}_mismatches"] = bad
        fields[f"{name}_s"] = dt
        fields[f"{name}_snr_db"] = round(snr_db(pcm, back), 2)
    if fixpoint:
        fields.update(fixpoint_timing(pcm))
    return fields


def fixpoint_timing(pcm: np.ndarray, bits: int = 6):
    """Sequential search vs the chunk fixpoint on one file, each warmed
    once and then timed best-of-3; their bytes must agree."""
    from bjxa_tpu.api import encode_pcm

    outs, times = {}, {}
    saved = os.environ.get("BJXA_ENCODE_FIXPOINT_CHUNKS")
    try:
        for mode in ("0", "auto"):
            os.environ["BJXA_ENCODE_FIXPOINT_CHUNKS"] = mode
            outs[mode] = encode_pcm(pcm, RATE, bits)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                encode_pcm(pcm, RATE, bits)
                best = min(best, time.perf_counter() - t0)
            times[mode] = best
    finally:
        if saved is None:
            os.environ.pop("BJXA_ENCODE_FIXPOINT_CHUNKS", None)
        else:
            os.environ["BJXA_ENCODE_FIXPOINT_CHUNKS"] = saved
    bad = mismatches(outs["0"], outs["auto"])
    check(bad == 0, f"fixpoint encode: {bad} bytes differ from sequential")
    return {"sequential_s": times["0"], "fixpoint_s": times["auto"],
            "fixpoint_mismatches": bad,
            "fixpoint_faster": times["auto"] < times["0"]}


def phase_error_path(tmp, seed, seconds=30):
    """Corrupt and truncated inputs through ``bjxa decode``: exit 1, the
    reference's message, and exactly the native valid prefix written."""
    rng = np.random.default_rng(seed + 3)
    cases = {}
    for bits in (4, 6, 8):
        data = bytearray(random_xa(rng, bits, 2, seconds * RATE))
        size = (4 * bits + 1) * 2
        nblocks = (len(data) - 32) // size
        blk = nblocks // 2 + bits
        channel = 1 if bits == 6 else 0
        data[32 + blk * size + channel * (4 * bits + 1)] |= 0xF0
        cases[f"corrupt{bits}"] = (bytes(data), "bjxa_decode: Protocol error")
    data = random_xa(rng, 6, 1, seconds * RATE)
    cases["truncated6"] = (data[: len(data) // 2 + 5], "fread: End of file")
    fields = {}
    for name, (data, msg) in cases.items():
        src, dst = tmp / f"err-{name}.xa", tmp / f"err-{name}.wav"
        src.write_bytes(data)
        rc, _o, err = bjxa("decode", str(src), str(dst))
        check(rc == 1, f"{name}: rc={rc}")
        check(msg in err, f"{name}: stderr {err.strip()!r}")
        header, frames, _ = native_decode(data)
        bad = mismatches(dst.read_bytes(),
                         header + frames.astype("<i2").tobytes())
        check(bad == 0, f"{name}: prefix differs from native in {bad} bytes")
        fields[f"{name}_prefix_frames"] = len(frames)
    fields["mismatches"] = 0
    return fields


def _best_time(fn, *args, reps: int):
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _compare_and_rate(fields, tag, n_msamples, kern, plain, *args,
                      reps: int = 5):
    """Run the kernel and the XLA version once (compiling; both times
    reported), check equality, then Msamples/s of each (best of ``reps``
    timed calls, the same count for both)."""
    import jax

    outs = []
    for name, fn in (("kernel", kern), ("xla", plain)):
        t0 = time.perf_counter()
        outs.append(jax.block_until_ready(fn(*args)))
        fields[f"{tag}_{name}_first_s"] = time.perf_counter() - t0
    _same([np.asarray(x).astype(np.int32) for x in outs[0]],
          [np.asarray(x).astype(np.int32) for x in outs[1]], tag)
    for name, fn in (("kernel", kern), ("xla", plain)):
        fields[f"{tag}_{name}_msps"] = n_msamples / _best_time(
            fn, *args, reps=reps)
    return outs


def _same(a, b, what: str) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        bad = int(np.count_nonzero(np.asarray(x) != np.asarray(y)))
        check(bad == 0, f"{what}: output {i} differs in {bad} elements")


def phase_kernels(seed, decode_shapes=((32768, 64), (32, 20672)),
                  encode_shape=(4096, 32), native_lanes=256, fields=None):
    """Each Pallas kernel against what XLA makes of the plain version;
    ``fields`` collects the results as they come (kept on failure)."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from bjxa_tpu.ops.decode import decode_words_xla
    from bjxa_tpu.ops.encode import encode_search_scan
    from bjxa_tpu.ops.filter import kernel_route
    from bjxa_tpu.ops.pallas_decode import decode_words
    from bjxa_tpu.ops.pallas_encode import encode_search_triton

    key = random.PRNGKey(seed)
    fields = {} if fields is None else fields
    fields.update(route=kernel_route(), host=platform.machine())
    bits = 8
    for lanes, nblocks in decode_shapes:
        kw, kf, ks, kst = random.split(random.fold_in(key, lanes), 4)
        words = random.randint(kw, (nblocks, bits, lanes), -(2**31),
                               2**31 - 1, jnp.int32)
        prof = (random.randint(kf, (nblocks, lanes), 0, 5) << 4
                | random.randint(ks, (nblocks, lanes), 0, 13)
                ).astype(jnp.uint8)
        state = random.randint(kst, (lanes, 2), -3000, 3000, jnp.int32)
        kern = partial(decode_words, bits=bits)
        plain = jax.jit(partial(decode_words_xla, bits=bits))
        outs = _compare_and_rate(
            fields, f"decode8_{lanes}x{nblocks}", lanes * nblocks * 32 / 1e6,
            kern, plain, prof, words, state)
        _none, end = decode_words(prof, words, state, bits=bits,
                                  with_output=False)
        _same([end], [outs[1][1]], "decode states-only")

    lanes, nblocks = encode_shape
    bits = 6
    pcm = random.randint(random.fold_in(key, 7), (nblocks, 32, lanes),
                         -(2**15), 2**15, jnp.int32)
    state = jnp.zeros((lanes, 2), jnp.int32)
    kern = partial(encode_search_triton, bits=bits)
    plain = partial(encode_search_scan, bits=bits)
    _compare_and_rate(fields, f"encode6_{lanes}x{nblocks}",
                      lanes * nblocks * 32 / 1e6, kern, plain, pcm, state)

    # both routes pick the native C++ encoder's profiles, on every bit depth
    from bjxa_tpu import native

    for bits in (4, 6, 8):
        x = np.asarray(pcm[:, :, :native_lanes])
        want = np.empty((nblocks, native_lanes), np.int32)
        for lane in range(native_lanes):
            st = np.zeros((1, 2), np.int32)
            blk = native.encode_blocks(
                x[:, :, lane].reshape(-1, 1).astype(np.int16), bits, st,
                search=True,
            )
            want[:, lane] = blk[:, 0, 0]
        st0 = jnp.zeros((native_lanes, 2), jnp.int32)
        xl = jnp.asarray(x)
        for name, fn in (("kernel", encode_search_triton),
                         ("xla", encode_search_scan)):
            got = np.asarray(fn(xl, st0, bits=bits)[0])
            bad = int(np.count_nonzero(got != want))
            check(bad == 0, f"encode{bits} {name}: {bad} profiles differ "
                  "from native")
    fields["native_profile_mismatches"] = 0
    for tag in [k[: -len("_kernel_msps")] for k in fields
                if k.endswith("_kernel_msps")]:
        fields[f"{tag}_winner"] = (
            "kernel" if fields[f"{tag}_kernel_msps"]
            > fields[f"{tag}_xla_msps"] else "xla"
        )
    return fields


def phase_four_cards(tmp, seed):
    """The sp ring (decode, 6-bit encode) and the dp corpus on 4 cards,
    each compared with one card (and, inside each phase, with the native
    reference)."""
    fields = {}
    diff = 0
    for cards in (1, 4):
        for phase, kw in (
            (phase_long_decode, {}),
            (phase_encode, dict(bits_list=(6,), truncate=False,
                                fixpoint=False)),
            (phase_corpus, {}),
        ):
            name = phase.__name__[len("phase_"):]
            got = phase(tmp, seed, devices=cards, **kw)
            fields.update({f"{name}_{cards}card_{k}": v
                           for k, v in got.items()})
    for pattern in ("long-whole-{}.wav", "long-segmented-{}.wav",
                    "music-6-{}.xa"):
        diff += mismatches((tmp / pattern.format(1)).read_bytes(),
                           (tmp / pattern.format(4)).read_bytes())
    for path in sorted((tmp / "corpus-wav-1").glob("*.wav")):
        diff += mismatches(path.read_bytes(),
                           (tmp / "corpus-wav-4" / path.name).read_bytes())
    check(diff == 0, f"4 cards differ from 1 card in {diff} bytes")
    fields["one_vs_four_mismatches"] = diff
    return fields


PHASES = ("long_decode", "corpus", "encode", "error_path", "kernels")


def run(phases, tmp: pathlib.Path, seed: int) -> bool:
    ok = True
    for name in phases:
        t0 = time.perf_counter()
        partial_fields = {}
        try:
            if name == "kernels":
                fields = phase_kernels(seed, fields=partial_fields)
            else:
                fields = globals()[f"phase_{name}"](tmp, seed)
        except Exception as e:  # report every phase, then fail the run
            ok = False
            report(name, ok=False, error=f"{type(e).__name__}: {e}",
                   seconds=time.perf_counter() - t0, **partial_fields)
            continue
        report(name, ok=True, seconds=time.perf_counter() - t0, **fields)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card phase (needs 4 GPUs)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    try:
        import bjxa_tpu
    except ImportError as e:
        print(f"chip_smoke: the bjxa_tpu package is not here: {e}",
              file=sys.stderr)
        return 2
    if pathlib.Path(bjxa_tpu.__file__).resolve().parent.parent != here:
        print("chip_smoke: bjxa_tpu was not imported from this checkout",
              file=sys.stderr)
        return 2

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX platform is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    from bjxa_tpu import native
    from bjxa_tpu.utils.compile_cache import enable_compile_cache

    if not native.available():
        print("chip_smoke: the native reference codec did not build",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    enable_compile_cache()

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bjxa-smoke-"))
    try:
        if args.four_cards:
            phases = ["four_cards"]
        else:
            phases = [p for p in args.phases.split(",") if p]
            unknown = set(phases) - set(PHASES)
            if unknown:
                print(f"chip_smoke: unknown phases {sorted(unknown)}",
                      file=sys.stderr)
                return 2
        ok = run(phases, tmp, args.seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-phase timeline of the corpus decode engine, serialized.

Runs the exact single-device batch path of ``decode_corpus`` with NO
pipelining and a perf_counter around every phase — staging, dispatch,
transfer landing, WAV serialization, disk write — so the depth-k engine's
remaining gap to the transfer roofline can be attributed: if the serialized
phase sum matches the pipelined engine's wall time, overlap is broken;
if the sum is larger, overlap works and the residual is per-phase cost.

Run manually on the GPU, alone (a second process on the card skews it):
    python tools/corpus_phase_probe.py
Env: BENCH_FILES/BENCH_BLOCKS/BENCH_BATCH_FILES as bench_corpus.py.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np

    from bjxa_tpu.utils.compile_cache import enable_compile_cache
    from bjxa_tpu.format import (
        XA_HEADER_SIZE,
        XAFormat,
        dump_pcm,
        dump_riff_header,
        dump_xa_header,
        parse_xa_header,
    )
    from bjxa_tpu.ops.decode import (
        decode_batch_packed,
        packed_layout,
        pad_bucket,
    )

    enable_compile_cache()

    bits = int(os.environ.get("BENCH_BITS", "8"))
    n_files = int(os.environ.get("BENCH_FILES", "32"))
    nblocks = int(os.environ.get("BENCH_BLOCKS", "20672"))
    batch_files = int(os.environ.get("BENCH_BATCH_FILES", "16"))
    channels = 2
    size = bits * 4 + 1

    rng = np.random.default_rng(7)
    samples = nblocks * 32
    data_len = nblocks * size * channels
    hdr = dump_xa_header(
        XAFormat(
            data_len=data_len,
            samples=samples,
            samples_rate=44100,
            bits=bits,
            channels=channels,
            initial_state=((0, 0), (0, 0)),
        )
    )
    payloads = []
    for _ in range(n_files):
        body = rng.integers(
            0, 256, size=(nblocks, channels, size), dtype=np.uint8
        )
        body[:, :, 0] = (
            rng.integers(0, 5, size=(nblocks, channels)) << 4
            | rng.integers(0, 13, size=(nblocks, channels))
        ).astype(np.uint8)
        payloads.append(hdr + body.tobytes())

    import tempfile

    out_dir = tempfile.mkdtemp(prefix="bjxa-phase-")
    gran = 256
    Bs = -(-nblocks // gran) * gran
    L = batch_files * channels
    W = bits
    nw, npr, nst = packed_layout(Bs, L, bits)

    def run_once(label):
        t = {"stage": 0.0, "dispatch": 0.0, "land": 0.0, "serialize": 0.0,
             "write": 0.0}
        t_all = time.perf_counter()
        for start in range(0, n_files, batch_files):
            chunk = payloads[start : start + batch_files]
            t0 = time.perf_counter()
            buf = np.zeros(nw + npr + nst, np.dtype("<i4"))
            words8 = buf[:nw].view(np.uint8).reshape(Bs, W, L, 4)
            prof = buf[nw : nw + npr].view(np.uint8)[: Bs * L].reshape(Bs, L)
            for i, data in enumerate(chunk):
                fmt = parse_xa_header(data)
                raw = np.frombuffer(
                    data, np.uint8, offset=XA_HEADER_SIZE,
                    count=fmt.blocks * fmt.block_size_xa,
                ).reshape(fmt.blocks, channels, size)
                lanes = slice(i * channels, (i + 1) * channels)
                prof[: fmt.blocks, lanes] = raw[:, :, 0]
                words8[: fmt.blocks, :, lanes, :] = (
                    raw[:, :, 1:]
                    .reshape(fmt.blocks, channels, W, 4)
                    .transpose(0, 2, 1, 3)
                )
            t1 = time.perf_counter()
            pcm = decode_batch_packed(buf, bits=bits, blocks=Bs, lanes=L)
            t2 = time.perf_counter()
            pcm = np.asarray(pcm)
            t3 = time.perf_counter()
            pcm = pcm.reshape(Bs, 32, -1)[:, :, : len(chunk) * 2]
            wavs = []
            for i in range(len(chunk)):
                frames = pcm[:, :, i * 2 : (i + 1) * 2].reshape(
                    Bs * 32, channels
                )[:samples]
                wavs.append(
                    dump_riff_header(samples * 4, 44100, channels)
                    + dump_pcm(frames)
                )
            t4 = time.perf_counter()
            for i, wav in enumerate(wavs):
                with open(
                    os.path.join(out_dir, f"{label}-{start + i}.wav"), "wb"
                ) as f:
                    f.write(wav)
            t5 = time.perf_counter()
            t["stage"] += t1 - t0
            t["dispatch"] += t2 - t1
            t["land"] += t3 - t2
            t["serialize"] += t4 - t3
            t["write"] += t5 - t4
        t["total"] = time.perf_counter() - t_all
        return t

    run_once("warm")  # compiles

    # --- pipelined timeline: timestamp every engine event ---------------
    from bjxa_tpu.parallel.corpus import decode_corpus

    xa_dir = os.path.join(out_dir, "xa")
    os.makedirs(xa_dir, exist_ok=True)
    for i, data in enumerate(payloads):
        with open(os.path.join(xa_dir, f"f{i:03d}.xa"), "wb") as f:
            f.write(data)
    import bjxa_tpu.parallel.corpus as corpus_mod

    events = []
    orig_pipe = corpus_mod._run_pipelined

    def traced_pipe(groups, batch_files_, submit, flush, depth=3):
        t_base = time.perf_counter()

        def ts(name, fn, *a):
            t0 = time.perf_counter() - t_base
            r = fn(*a)
            events.append((name, round(t0, 2),
                           round(time.perf_counter() - t_base, 2)))
            return r

        return orig_pipe(
            groups,
            batch_files_,
            lambda *a: ts("submit", submit, *a),
            lambda *a: ts("flush", flush, *a),
            depth,
        )

    corpus_mod._run_pipelined = traced_pipe
    t0 = time.perf_counter()
    decode_corpus(xa_dir, os.path.join(out_dir, "wav"),
                  batch_files=batch_files,
                  manifest_path=os.path.join(out_dir, "m.jsonl"))
    pipelined_s = time.perf_counter() - t0
    corpus_mod._run_pipelined = orig_pipe
    print(json.dumps({"metric": "corpus_pipeline_timeline",
                      "pipelined_s": round(pipelined_s, 2),
                      "events": events}))

    t = run_once("timed")
    wav_bytes = n_files * (samples * channels * 2 + 44)
    print(
        json.dumps(
            {
                "metric": "corpus_phase_serialized",
                **{k: round(v, 2) for k, v in t.items()},
                "files": n_files,
                "files_per_s": round(n_files / t["total"], 1),
                "mb_out_per_s": round(wav_bytes / t["total"] / 1e6, 1),
            }
        )
    )
    import shutil

    shutil.rmtree(out_dir)


if __name__ == "__main__":
    main()

"""End-to-end corpus decode benchmark: XA files on disk -> WAV files on disk.

Measures the whole engine — header parse, host lane-major staging, device
transfer, fused-kernel decode, WAV serialization, manifest bookkeeping —
in files/s and Msamples/s, directly comparable to the reference CLI's
measured ~77 files/s (stereo 8-bit, 1.32 Msamples/file, one Xeon core;
BASELINE.md).

Not the driver headline bench; run manually:
    python benchmarks/bench_corpus.py
Env: BENCH_FILES (default 64), BENCH_BLOCKS (default 20672 blocks
~ 0.66 Msamples/channel, the fixture size), BENCH_BITS (default 8).
"""
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np

    from bjxa_tpu.utils.compile_cache import enable_compile_cache
    from bjxa_tpu.format import XAFormat, dump_xa_header
    from bjxa_tpu.parallel.corpus import decode_corpus

    # shapes compile once ever, not once per bench run
    enable_compile_cache()

    bits = int(os.environ.get("BENCH_BITS", "8"))
    n_files = int(os.environ.get("BENCH_FILES", "64"))
    nblocks = int(os.environ.get("BENCH_BLOCKS", "20672"))
    # 16 files x ~2.6 MB PCM per batch: large enough that the fixed
    # per-transfer cost is noise
    batch_files = int(os.environ.get("BENCH_BATCH_FILES", "16"))
    channels = 2
    size = bits * 4 + 1

    rng = np.random.default_rng(7)
    work = tempfile.mkdtemp(prefix="bjxa-bench-corpus-")
    src = os.path.join(work, "xa")
    dst = os.path.join(work, "wav")
    os.makedirs(src)

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
    t_gen0 = time.perf_counter()
    for i in range(n_files):
        body = rng.integers(
            0, 256, size=(nblocks, channels, size), dtype=np.uint8
        )
        body[:, :, 0] = (
            rng.integers(0, 5, size=(nblocks, channels)) << 4
            | rng.integers(0, 13, size=(nblocks, channels))
        ).astype(np.uint8)
        with open(os.path.join(src, f"f{i:05d}.xa"), "wb") as f:
            f.write(hdr)
            f.write(body.tobytes())
    gen_s = time.perf_counter() - t_gen0

    # warm the compile cache with one batch-shaped run, then time fresh.
    decode_corpus(src, dst, batch_files=batch_files,
                  manifest_path=os.path.join(work, "warm.jsonl"))
    shutil.rmtree(dst)

    import jax
    import jax.numpy as jnp

    # --- transfer-size ramp: separate fixed cost from bandwidth ---------
    # One transfer costs ~fixed + n/bw over the host-device link; fitting
    # both terms attributes the engine's per-batch round trips separately
    # from its byte volume.  Least squares over a size ramp, min-of-reps
    # per size (a slow tail is contention, not capability).
    def ramp(direction):
        sizes = [1 << 16, 1 << 20, 1 << 22, 1 << 24, 1 << 25]
        ts = []
        for n in sizes:
            host = np.zeros(n, np.uint8)
            best = None
            for r in range(3):
                if direction == "up":
                    host[0] = r
                    t0 = time.perf_counter()
                    jax.device_put(host).block_until_ready()
                    d = time.perf_counter() - t0
                else:
                    buf = (jnp.zeros(n, jnp.uint8) + r).block_until_ready()
                    t0 = time.perf_counter()
                    np.asarray(buf)
                    d = time.perf_counter() - t0
                best = d if best is None else min(best, d)
            ts.append(best)
        A = np.stack([np.ones(len(sizes)), np.asarray(sizes, float)], 1)
        (fixed, inv_bw), *_ = np.linalg.lstsq(A, np.asarray(ts), rcond=None)
        if inv_bw <= 0 or fixed < -1e-3:
            # a congested/noisy ramp can fit a non-physical negative
            # slope or intercept; report the fit as failed instead of
            # clamping it into an absurd model roofline
            return None, None
        return max(fixed, 0.0), 1.0 / inv_bw

    up_fixed_s, up_bw = ramp("up")
    down_fixed_s, down_bw = ramp("down")
    ramp_ok = up_bw is not None and down_bw is not None

    # --- interleaved probes + repeated runs, median reporting -----------
    # The link's rate varies between runs; a single probe paired with a
    # single run confounds engine quality with link contention.  Probes at
    # batch-sized transfers bracket EVERY engine run; each run's
    # utilization uses the faster of its two bracketing probes per
    # direction (the link's demonstrated capability at that moment), and
    # the MEDIAN across runs is the headline (the best run is reported
    # alongside — it is the optimistic pairing, not the typical one).
    base = jnp.zeros(batch_files * channels * samples, jnp.int16)
    host_buf = np.zeros(base.size, np.int16)

    def probe_link(tag):
        down, up = [], []
        for r in range(3):
            # a fresh device array per rep — rereading one array returns
            # the runtime's cached host copy and measures nothing
            buf = (base + r + tag).block_until_ready()
            t = time.perf_counter()
            np.asarray(buf)
            down.append(time.perf_counter() - t)
            host_buf[0] = r + tag  # fresh host bytes: defeat dedup
            t = time.perf_counter()
            jax.device_put(host_buf).block_until_ready()
            up.append(time.perf_counter() - t)
        nbytes = base.size * 2
        return nbytes / min(down) / 1e6, nbytes / min(up) / 1e6

    total_samples = n_files * samples * channels
    wav_bytes = total_samples * 2 + n_files * 44
    xa_bytes = n_files * (32 + data_len)
    n_batches = -(-n_files // batch_files)

    reps = int(os.environ.get("BENCH_REPS", "5"))
    probes = [probe_link(100)]
    runs = []
    for rep in range(reps):
        t0 = time.perf_counter()
        res = decode_corpus(
            src, dst, batch_files=batch_files,
            manifest_path=os.path.join(work, f"timed{rep}.jsonl"),
        )
        d = time.perf_counter() - t0
        assert res.converted == n_files, res
        shutil.rmtree(dst)
        probes.append(probe_link(101 + rep))
        runs.append(d)

    def run_stats(i, d):
        d1, u1 = probes[i]
        d2, u2 = probes[i + 1]
        down_mb_s, up_mb_s = max(d1, d2), max(u1, u2)
        up_s = xa_bytes / 1e6 / up_mb_s
        down_s = wav_bytes / 1e6 / down_mb_s
        # duplex roofline: uploads ride under downloads (PCIe is
        # full-duplex), so the floor is the bigger direction alone
        return {
            "s": d,
            "files_per_s": n_files / d,
            "util_serial": (up_s + down_s) / d,
            "util_duplex": max(up_s, down_s) / d,
        }

    stats = [run_stats(i, d) for i, d in enumerate(runs)]
    by_time = sorted(stats, key=lambda s: s["s"])
    best = by_time[0]
    median = by_time[len(by_time) // 2]

    # model roofline from the ramp fit: per-batch fixed round trips plus
    # byte volume at fitted bandwidth (duplex floor: the slower-modeled
    # direction alone)
    if ramp_ok:
        model_up = n_batches * up_fixed_s + xa_bytes / up_bw
        model_down = n_batches * down_fixed_s + wav_bytes / down_bw
        model_duplex_s = max(model_up, model_down)
    else:
        model_duplex_s = None

    print(
        json.dumps(
            {
                "metric": "corpus_decode_files_per_s",
                "value": round(median["files_per_s"], 1),
                "unit": "files/s",
                "best_files_per_s": round(best["files_per_s"], 1),
                "msamples_per_s": round(
                    total_samples * median["files_per_s"] / n_files / 1e6, 1
                ),
                "files": n_files,
                "samples_per_file": samples * channels,
                "gen_s": round(gen_s, 1),
                "runs_s": [round(s["s"], 2) for s in stats],
                "probe_down_mb_s": [round(p[0], 1) for p in probes],
                "probe_up_mb_s": [round(p[1], 1) for p in probes],
                "median_utilization": round(median["util_serial"], 3),
                "median_duplex_utilization": round(
                    median["util_duplex"], 3
                ),
                "best_utilization": round(best["util_serial"], 3),
                "best_duplex_utilization": round(best["util_duplex"], 3),
                "ramp_fit_ok": ramp_ok,
                "ramp_up_fixed_ms": round(up_fixed_s * 1e3, 1)
                if up_bw is not None else None,
                "ramp_up_mb_s": round(up_bw / 1e6, 1)
                if up_bw is not None else None,
                "ramp_down_fixed_ms": round(down_fixed_s * 1e3, 1)
                if down_bw is not None else None,
                "ramp_down_mb_s": round(down_bw / 1e6, 1)
                if down_bw is not None else None,
                "model_duplex_s": round(model_duplex_s, 2)
                if ramp_ok else None,
                "model_duplex_utilization": round(
                    model_duplex_s / median["s"], 3
                )
                if ramp_ok else None,
                "backend": jax.default_backend(),
                "vs_baseline": round(median["files_per_s"] / 77.0, 2),
            }
        )
    )
    shutil.rmtree(work)


if __name__ == "__main__":
    main()

"""Segmented bounded-memory decode: throughput + peak RSS on a big file.

Generates a large synthetic XA on disk, decodes it through the CLI's
segmented path (`_decode_segmented` via api.decode_xa_stream), and prints
the end-to-end rate alongside the process's peak RSS — the evidence for
"device-rate decode at O(segment) memory".  Like every disk->disk number,
the rate includes the payload upload and the PCM download.

Run manually from the repo root: python benchmarks/bench_segmented.py
Env: BENCH_BLOCKS (default 2_097_152 ~ 105 MB XA / 537 MB PCM at 6-bit
stereo), BENCH_SEGMENT (default 65536).
"""
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np

    from bjxa_tpu.utils.compile_cache import enable_compile_cache
    from bjxa_tpu.format import XAFormat, dump_xa_header

    enable_compile_cache()
    bits, channels = 6, 2
    nblocks = int(os.environ.get("BENCH_BLOCKS", str(2 * 1024 * 1024)))
    segment = int(os.environ.get("BENCH_SEGMENT", "65536"))
    size = bits * 4 + 1

    work = tempfile.mkdtemp(prefix="bjxa-bench-seg-")
    src = os.path.join(work, "big.xa")
    dst = os.path.join(work, "big.wav")
    rng = np.random.default_rng(5)
    fmt = XAFormat(
        data_len=nblocks * size * channels,
        samples=nblocks * 32,
        samples_rate=44100,
        bits=bits,
        channels=channels,
        initial_state=((0, 0), (0, 0)),
    )
    t0 = time.perf_counter()
    with open(src, "wb") as f:
        f.write(dump_xa_header(fmt))
        step = 1 << 16
        for start in range(0, nblocks, step):
            nb = min(step, nblocks - start)
            body = rng.integers(
                0, 256, size=(nb, channels, size), dtype=np.uint8
            )
            body[:, :, 0] = (
                rng.integers(0, 5, size=(nb, channels)) << 4
                | rng.integers(0, 13, size=(nb, channels))
            ).astype(np.uint8)
            f.write(body.tobytes())
    gen_s = time.perf_counter() - t0

    from bjxa_tpu import cli

    # bracket every rep with a D2H probe so each rate can be read against
    # the link's state at that moment
    import jax
    import jax.numpy as jnp

    probe_base = jnp.zeros(16 << 20, jnp.int16)  # 32 MB

    def probe(tag):
        buf = (probe_base + tag).block_until_ready()
        t = time.perf_counter()
        np.asarray(buf)
        return round(probe_base.size * 2 / (time.perf_counter() - t) / 1e6, 1)

    reps = int(os.environ.get("BENCH_REPS", "3"))
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    times, probes = [], [probe(1)]
    for rep in range(reps):
        t0 = time.perf_counter()
        rc = cli.main(
            ["bjxa", "decode", "--segment-blocks", str(segment), src, dst]
        )
        times.append(time.perf_counter() - t0)
        assert rc == 0
        probes.append(probe(2 + rep))
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    samples = fmt.samples * channels
    out_bytes = os.path.getsize(dst)
    dt = sorted(times)[len(times) // 2]
    print(
        json.dumps(
            {
                "metric": "segmented_decode_rate",
                "value": round(samples / dt / 1e6, 1),
                "unit": "Msamples/s",
                "xa_mb": round(fmt.data_len / 1e6, 1),
                "pcm_mb": round(out_bytes / 1e6, 1),
                "seconds_median": round(dt, 2),
                "runs_s": [round(t, 2) for t in times],
                "probe_down_mb_s": probes,
                "pcm_mb_per_s": round(out_bytes / dt / 1e6, 1),
                "segment_blocks": segment,
                "gen_s": round(gen_s, 1),
                "peak_rss_mb": round(rss1 / 1024, 1),
                "rss_growth_mb": round((rss1 - rss0) / 1024, 1),
            }
        )
    )
    os.remove(src)
    os.remove(dst)
    os.rmdir(work)


if __name__ == "__main__":
    main()

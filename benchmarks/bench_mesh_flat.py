"""Mesh-path D2H layout: 3-D [B, 32, L] results vs flat per-shard vectors.

Round-3 left the shard_map corpus paths returning 3-D PCM whose small
minor dim transfers at ~1/3 link rate (the runtime pads the trailing dim
to the 128-lane tile during D2H — ROADMAP r3 #6); round 4 moved the
corpus engine's mesh branch to packed-words staging with FLAT per-shard
output (``parallel/sharded.decode_corpus_sharded_words``).  This bench
measures both paths end to end (host staging -> H2D -> decode -> D2H ->
host materialize) on a 1-device mesh of the real chip, at a typical
corpus batch shape, and prints the before/after for PERFORMANCE.md.

Run manually from the repo root: python benchmarks/bench_mesh_flat.py
Env: BENCH_BLOCKS (default 20672), BENCH_FILES (default 16, stereo).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import numpy as np

    from bjxa_tpu.utils.compile_cache import enable_compile_cache
    from bjxa_tpu.ops.decode import words_from_blocks_host
    from bjxa_tpu.parallel.mesh import make_mesh
    from bjxa_tpu.parallel.sharded import (
        decode_corpus_sharded_lanes,
        decode_corpus_sharded_words,
    )

    enable_compile_cache()
    bits = 8
    B = int(os.environ.get("BENCH_BLOCKS", "20672"))
    n_files = int(os.environ.get("BENCH_FILES", "16"))
    channels = 2
    L = n_files * channels
    S = bits * 4 + 1

    rng = np.random.default_rng(3)
    blocks_t = rng.integers(0, 256, size=(B, S, L), dtype=np.uint8)
    blocks_t[:, 0, :] = (
        rng.integers(0, 5, size=(B, L)) << 4
        | rng.integers(0, 13, size=(B, L))
    ).astype(np.uint8)
    states = np.zeros((L, 2), np.int32)
    mesh = make_mesh(jax.devices()[:1], dp=1, sp=1)
    pcm_bytes = B * 32 * L * 2

    def run_lanes():
        pcm, _end, _valid = decode_corpus_sharded_lanes(
            blocks_t, states, bits=bits, mesh=mesh
        )
        out = np.asarray(pcm)
        assert out.shape == (B, 32, L)
        return out

    def run_words():
        prof, words = words_from_blocks_host(blocks_t, bits)
        pcm_flat, reassemble = decode_corpus_sharded_words(
            prof, words, states, bits=bits, mesh=mesh
        )
        out = reassemble(np.asarray(pcm_flat))
        assert out.shape == (B, 32, L)
        return out

    ref = run_lanes()  # warm compiles
    got = run_words()
    np.testing.assert_array_equal(ref, got)  # byte-identical paths

    def measure(fn, reps=3):
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            d = time.perf_counter() - t0
            best = d if best is None else min(best, d)
        return best

    t_lanes = measure(run_lanes)
    t_words = measure(run_words)
    print(
        json.dumps(
            {
                "metric": "mesh_batch_seconds",
                "shape": f"[{B},{S},{L}]",
                "pcm_mb": round(pcm_bytes / 1e6, 1),
                "lanes_3d_s": round(t_lanes, 2),
                "words_flat_s": round(t_words, 2),
                "lanes_3d_mb_s": round(pcm_bytes / t_lanes / 1e6, 1),
                "words_flat_mb_s": round(pcm_bytes / t_words / 1e6, 1),
                "speedup": round(t_lanes / t_words, 2),
                "backend": jax.default_backend(),
            }
        )
    )


if __name__ == "__main__":
    main()

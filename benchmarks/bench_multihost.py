"""Multi-process corpus scaling bench: files/s at 1 -> 2 -> 4 processes.

Each "host" is a separate OS process joined through ``jax.distributed``
(local coordinator, gloo CPU collectives) running the real CLI corpus
action on its round-robin shard — the same wiring a multi-host GPU job
uses, with the CPU backend standing in for per-host cards.  The metric is the global
files/s printed by rank 0's ``--stats`` line, whose elapsed time is the
slowest process (see ``distributed.allreduce_counters``).

Caveat for this environment: the box has ``os.cpu_count()`` cores in total,
so compute-bound scaling saturates once processes outnumber cores; the
sharding/collective overhead this bench isolates is what would bound a real
multi-host run (where each process has its own chips).

Usage: python benchmarks/bench_multihost.py [--files N] [--samples N]
"""

import argparse
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_corpus(src: pathlib.Path, n_files: int, samples: int) -> None:
    import jax

    # corpus generation is setup, not measurement — keep it off the card
    # (the workers own the devices)
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from bjxa_tpu.api import encode_pcm

    rng = np.random.default_rng(0)
    src.mkdir(parents=True, exist_ok=True)
    base = rng.integers(-25000, 25000, size=(samples, 2)).astype(np.int16)
    for i in range(n_files):
        # cheap per-file variation; encode once would hide staging costs
        pcm = np.roll(base, i * 97, axis=0)
        (src / f"f{i:04d}.xa").write_bytes(
            encode_pcm(pcm, 44100, 8, search=False)
        )


def run_job(src, out, n_processes, batch_files, pin=True) -> dict:
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["BJXA_PLATFORM"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    # Pin every worker to one core: each simulated "host" then has equal
    # compute whether the job has 1 process or N, so files/s measures the
    # sharding/collective overhead instead of this box's core count.
    ncores = os.cpu_count() or 1
    pin = pin and shutil.which("taskset") is not None
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            (["taskset", "-c", str(i % ncores)] if pin else [])
            + [
                sys.executable,
                "-m",
                "bjxa_tpu.cli",
                "corpus",
                "--coordinator",
                f"127.0.0.1:{port}",
                "--num-processes",
                str(n_processes),
                "--process-id",
                str(i),
                "--batch-files",
                str(batch_files),
                "--stats",
                str(src),
                str(out),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for i in range(n_processes)
    ]
    stats = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{stderr}\n{stdout}")
        for line in stdout.splitlines():
            if line.startswith("stats "):
                parts = line.split()[1:]
                stats = {
                    parts[j]: float(parts[j + 1])
                    for j in range(0, len(parts), 2)
                }
    wall = time.perf_counter() - t0
    stats["wall_s"] = wall
    return stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=32)
    ap.add_argument("--samples", type=int, default=66150)
    ap.add_argument("--batch-files", type=int, default=8)
    ap.add_argument("--procs", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument(
        "--constant-hardware",
        action="store_true",
        help="compare 1 unpinned process (all cores) against N pinned "
        "processes (1 core each) — isolates pure distribution overhead "
        "at fixed total hardware, the honest metric on a small box",
    )
    args = ap.parse_args()

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bjxa-mh-"))
    src = tmp / "src"
    print(f"corpus: {args.files} stereo 8-bit files x {args.samples} samples",
          flush=True)
    make_corpus(src, args.files, args.samples)

    results = {}
    for n in args.procs:
        pin = not (args.constant_hardware and n == 1)
        out = tmp / f"out{n}"
        if out.exists():
            shutil.rmtree(out)
        # warm run populates the persistent compile cache; measured run
        # reflects steady-state conversion
        run_job(src, out, n, args.batch_files, pin=pin)
        shutil.rmtree(out)
        stats = run_job(src, out, n, args.batch_files, pin=pin)
        results[n] = stats
        print(json.dumps({"processes": n, "pinned": pin, **stats}),
              flush=True)

    if args.constant_hardware:
        base = results[min(results)]["files_per_s"]
        for n, stats in sorted(results.items()):
            if n == min(results):
                continue
            print(
                f"constant-hardware: {n} pinned procs reach "
                f"{stats['files_per_s'] / base:.2f}x of 1 unpinned proc "
                f"on the same cores",
                flush=True,
            )
        shutil.rmtree(tmp)
        return

    base = results[min(results)]
    for n, stats in sorted(results.items()):
        eff = (
            stats["files_per_s"]
            / (base["files_per_s"] * n / min(results))
        )
        print(
            f"processes={n} files/s={stats['files_per_s']:.2f} "
            f"efficiency_vs_linear={eff:.2f}",
            flush=True,
        )
    shutil.rmtree(tmp)


if __name__ == "__main__":
    main()

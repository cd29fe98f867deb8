"""Real multi-process distribution tests.

Unlike ``test_corpus.py::test_corpus_multihost_sharding`` (which validates
the round-robin arithmetic in one process), these spawn genuinely separate
OS processes that join one job through ``jax.distributed`` with a local
coordinator and gloo CPU collectives: separate device visibility, separate
file sharding, a real cross-process counter reduction.  Reference anchor:
the decoder-per-file model (``bjxa.3.rst.in:119-120``) scaled to SURVEY
§2.5's distributed-corpus row.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bjxa_tpu.api import encode_pcm, xa_to_wav
from bjxa_tpu.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_workers(cfgs, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, json.dumps(cfg)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for cfg in cfgs
    ]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"worker failed:\n{err}\n{out}"
        reports.append(json.loads(out.splitlines()[-1]))
    return sorted(reports, key=lambda r: r["process_index"])


@pytest.fixture()
def xa_corpus(tmp_path):
    rng = np.random.default_rng(7)
    src = tmp_path / "src"
    src.mkdir()
    expect = {}
    for i, (bits, channels, samples) in enumerate(
        [(4, 1, 120), (6, 2, 321), (8, 2, 96), (6, 1, 500), (8, 1, 257)]
    ):
        sig = rng.integers(-25000, 25000, size=(samples, channels)).astype(
            np.int16
        )
        xa = encode_pcm(sig, 44100, bits, search=False)
        (src / f"f{i}.xa").write_bytes(xa)
        expect[f"f{i}"] = xa_to_wav(xa)
    return src, expect


def test_two_process_corpus_decode(tmp_path, xa_corpus):
    src, expect = xa_corpus
    out = tmp_path / "out"
    out.mkdir()
    port = _free_port()
    cfgs = [
        {
            "coordinator": f"127.0.0.1:{port}",
            "num_processes": 2,
            "process_id": i,
            "src": str(src),
            "out": str(out),
        }
        for i in range(2)
    ]
    reports = _spawn_workers(cfgs)

    # the runtime really had two processes, each with its own local devices
    for i, rep in enumerate(reports):
        assert rep["process_index"] == i
        assert rep["process_count"] == 2
        assert rep["global_devices"] == 2 * rep["local_devices"]

    # disjoint shards covering the whole corpus
    done0 = set(reports[0]["inputs_done"])
    done1 = set(reports[1]["inputs_done"])
    assert done0 and done1
    assert not (done0 & done1)
    assert done0 | done1 == {f"{stem}.xa" for stem in expect}

    # cross-host reduction agreed on the global totals in both processes
    total_samples = sum(
        len(wav[44:]) // 2 for wav in expect.values()
    )
    for rep in reports:
        assert rep["global_converted"] == len(expect)
        assert rep["global_failed"] == 0
        assert rep["global_files"] == len(expect)
        assert rep["global_samples"] == total_samples
    assert reports[0]["converted"] + reports[1]["converted"] == len(expect)

    # combined output is byte-identical to the single-process result
    for stem, wav in expect.items():
        assert (out / f"{stem}.wav").read_bytes() == wav


def test_two_process_four_device_corpus(tmp_path, xa_corpus):
    """2 OS processes (gloo) x 4 virtual devices each — the configuration
    a real pod uses: every process drives its round-robin file shard
    through ``decode_corpus(mesh=)`` over a LOCAL 4-device mesh, batches
    genuinely shard across the 4 devices (asserted via sharding
    introspection inside each worker), shards stay disjoint, and the
    combined output is byte-identical to the single-everything result
    (VERDICT r3 item 4)."""
    src, expect = xa_corpus
    out = tmp_path / "out"
    out.mkdir()
    port = _free_port()
    cfgs = [
        {
            "coordinator": f"127.0.0.1:{port}",
            "num_processes": 2,
            "process_id": i,
            "src": str(src),
            "out": str(out),
            "devices": 4,
        }
        for i in range(2)
    ]
    reports = _spawn_workers(cfgs)

    for i, rep in enumerate(reports):
        assert rep["process_index"] == i
        assert rep["process_count"] == 2
        assert rep["local_devices"] == 4
        assert rep["global_devices"] == 8
        # every sharded batch this process ran spanned all 4 local devices
        assert rep["mesh_shardings"], "no batch used the sharded path"
        assert all(n == 4 for n in rep["mesh_shardings"]), rep

    done0 = set(reports[0]["inputs_done"])
    done1 = set(reports[1]["inputs_done"])
    assert done0 and done1
    assert not (done0 & done1)
    assert done0 | done1 == {f"{stem}.xa" for stem in expect}
    for rep in reports:
        assert rep["global_converted"] == len(expect)
        assert rep["global_failed"] == 0
    for stem, wav in expect.items():
        assert (out / f"{stem}.wav").read_bytes() == wav


def test_two_process_corpus_encode(tmp_path):
    from bjxa_tpu.api import encode_pcm as encode_one
    from bjxa_tpu.format import dump_pcm, dump_riff_header

    rng = np.random.default_rng(8)
    src = tmp_path / "wav"
    out = tmp_path / "xa"
    src.mkdir()
    out.mkdir()
    expect = {}
    for i, (channels, samples) in enumerate([(1, 200), (2, 333), (1, 64)]):
        pcm = rng.integers(-30000, 30000, size=(samples, channels)).astype(
            np.int16
        )
        (src / f"w{i}.wav").write_bytes(
            dump_riff_header(pcm.size * 2, 44100, channels) + dump_pcm(pcm)
        )
        expect[f"w{i}"] = encode_one(pcm, 44100, 6, search=True)

    port = _free_port()
    cfgs = [
        {
            "coordinator": f"127.0.0.1:{port}",
            "num_processes": 2,
            "process_id": i,
            "src": str(src),
            "out": str(out),
            "encode": True,
            "bits": 6,
        }
        for i in range(2)
    ]
    reports = _spawn_workers(cfgs)

    done0 = set(reports[0]["inputs_done"])
    done1 = set(reports[1]["inputs_done"])
    assert not (done0 & done1)
    assert done0 | done1 == {f"{stem}.wav" for stem in expect}
    for rep in reports:
        assert rep["global_converted"] == len(expect)
    for stem, xa in expect.items():
        assert (out / f"{stem}.xa").read_bytes() == xa


@pytest.mark.slow
def test_two_process_cli_corpus(tmp_path, xa_corpus):
    """The CLI's --coordinator/--num-processes/--process-id flags drive a
    real 2-process job; only process 0 prints the (global) summary.
    Slow-marked: the two library-level 2-process tests above exercise the
    same wiring; this adds only the CLI flag plumbing."""
    src, expect = xa_corpus
    out = tmp_path / "out"
    out.mkdir()
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["BJXA_PLATFORM"] = "cpu"
    # 4 virtual devices per process: the CLI auto-meshes over its LOCAL
    # devices while jax.distributed shards the file list — the full
    # N-process x M-device composition through the shipped tool.
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                "-m",
                "bjxa_tpu.cli",
                "corpus",
                "--coordinator",
                f"127.0.0.1:{port}",
                "--num-processes",
                "2",
                "--process-id",
                str(i),
                "--stats",
                str(src),
                str(out),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"cli worker failed:\n{stderr}\n{stdout}"
        outs.append(stdout)
    # exactly one process printed a summary (gloo logs rank-connect lines
    # on stdout, so match the summary itself), and it holds global totals
    printed = [o for o in outs if "converted" in o]
    assert len(printed) == 1, outs
    assert f"converted {len(expect)} skipped 0 failed 0" in printed[0]
    assert "stats" in printed[0] and "files_per_s" in printed[0]
    for stem, wav in expect.items():
        assert (out / f"{stem}.wav").read_bytes() == wav


def test_initialize_validation():
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1", process_id=0)
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1", num_processes=2, process_id=5)
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1", num_processes=0, process_id=0)
    # nothing requested anywhere -> plain single-process, no-op
    assert distributed.initialize(None, None, None) is False


def test_process_info_single():
    index, count = distributed.process_info()
    assert (index, count) == (0, 1)


def test_allreduce_identity_single_process():
    from bjxa_tpu.utils.profiler import Counters

    assert distributed.allreduce_sum([3, 4]) == [3, 4]
    c = Counters(files=2, samples=100)
    assert distributed.allreduce_counters(c) is c


@pytest.mark.parametrize(
    "coordinator, n_proc, pid, gpus, want",
    [
        ("localhost:1234", 4, 2, 4, [2]),  # one card each
        ("127.0.0.1:1234", 2, 1, 4, [2, 3]),  # cards split evenly
        ("node7:1234", 16, 9, 8, None),  # multi-host: layout unknown
        ("10.0.0.7:1234", 4, 3, 8, None),  # one process per host
        ("node7:1234", 2, 0, 0, None),  # remote host's cards not counted
        (None, None, None, 4, None),  # single process: JAX decides
    ],
)
def test_gpu_local_device_ids(coordinator, n_proc, pid, gpus, want):
    assert distributed.gpu_local_device_ids(
        coordinator, n_proc, pid, gpus
    ) == want


def test_gpu_local_device_ids_refuses_oversubscription():
    with pytest.raises(ValueError, match="card of its own"):
        distributed.gpu_local_device_ids("localhost:1", 5, 0, 4)
    with pytest.raises(ValueError, match="no GPU"):
        distributed.gpu_local_device_ids("localhost:1", 1, 0, 0)


def test_initialize_passes_local_devices_on_gpu(monkeypatch):
    """On a GPU platform initialize() hands jax.distributed the process's
    own cards; on the CPU it asks for gloo and names no cards."""
    import jax

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(distributed, "_enable_rank_cache_writes",
                        lambda: None)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    import types

    monkeypatch.setattr(jax, "config", types.SimpleNamespace(
        jax_platforms="cuda", update=None))
    assert distributed.initialize("localhost:9", 2, 1) is True
    assert seen["local_device_ids"] == [2, 3]
    assert distributed.visible_gpus() == 4


def test_initialize_names_no_cards_for_a_remote_coordinator(monkeypatch):
    """A one-process-per-host job (coordinator on another host) keeps
    JAX's default: the process opens every card it can see."""
    import types

    import jax

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(distributed, "_enable_rank_cache_writes",
                        lambda: None)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3,4,5,6,7")
    monkeypatch.setattr(jax, "config", types.SimpleNamespace(
        jax_platforms="cuda", update=None))
    assert distributed.initialize("node0.cluster:8476", 4, 3) is True
    assert seen["local_device_ids"] is None
    assert seen["process_id"] == 3 and seen["num_processes"] == 4

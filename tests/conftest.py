"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh: sharding logic is validated
without accelerator hardware, and Pallas kernels run in interpret mode
where a test asks for it.  Tests that need a real GPU carry the ``gpu``
marker and skip without one; on a GPU host ``python -m pytest -m gpu
tests/`` runs them on the card (that selection alone leaves the platform
unpinned), and ``python chip_smoke.py`` drives the same paths at full
size.  ``jax.config.update()`` in :func:`pytest_configure` pins the
platform before any backend client is instantiated by the tests.
"""

import os
import pathlib

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax

from bjxa_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persist XLA compilations across pytest runs: the suite is dominated by
# CPU-backend compiles of large static shapes, which never change between
# runs of the same code.  Safe because the cache key covers the HLO.
enable_compile_cache(min_compile_time_secs=0.5)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--slow",
        action="store_true",
        default=False,
        help="also run tests marked slow (the full Pallas-interpret matrix)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long Pallas-interpret / big-shape case (run with --slow)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a real GPU (skips without one; see chip_smoke.py)",
    )
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow"):
        return
    skip = pytest.mark.skip(reason="slow; pass --slow to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's platform is a GPU."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: python -m pytest -m gpu on the card")


@pytest.fixture
def triton_interpret(monkeypatch):
    """Run the GPU kernel route on the CPU: ``kernel_route()`` answers
    ``"triton"`` and the Pallas kernels run in interpret mode, so every
    pipeline traces exactly the calls it makes on the card."""
    import functools

    from bjxa_tpu.ops import filter as filt
    from bjxa_tpu.ops import pallas_decode, pallas_encode
    from bjxa_tpu.utils.hygiene import clear_compiled_caches

    monkeypatch.setitem(filt.ROUTES, "cpu", "triton")
    monkeypatch.setattr(
        pallas_decode, "decode_words",
        functools.partial(pallas_decode.decode_words, interpret=True),
    )
    monkeypatch.setattr(
        pallas_encode, "encode_search_triton",
        functools.partial(pallas_encode.encode_search_triton,
                          interpret=True),
    )
    clear_compiled_caches()  # drop traces made on the xla route
    yield
    clear_compiled_caches()


@pytest.fixture(scope="module", autouse=True)
def _compiled_cache_hygiene():
    """Release compiled executables between test modules.

    Every distinct shape the suite compiles stays mmap'd (XLA:CPU JIT
    code pages + glibc arena retention); across the full ``--slow`` run
    the process crossed the kernel's default 65530 ``vm.max_map_count``
    and SIGSEGV'd inside XLA's executable deserializer (measured:
    64415 maps / 18.4 GB RSS just before the crash).  Dropping caches at module boundaries keeps the map
    count bounded; the persistent compilation cache makes the later
    recompiles cheap disk reloads.
    """
    yield
    from bjxa_tpu.utils.hygiene import clear_compiled_caches

    clear_compiled_caches()

REFERENCE_DIR = pathlib.Path(
    os.environ.get("BJXA_REFERENCE_DIR", "/root/reference")
)
FIXTURE_DIR = REFERENCE_DIR / "test"


@pytest.fixture(scope="session")
def fixture_dir():
    if not FIXTURE_DIR.is_dir():
        pytest.skip("reference fixture corpus not available")
    return FIXTURE_DIR


@pytest.fixture(scope="session")
def ref_bjxa(tmp_path_factory):
    """The reference CLI binary, compiled once per session (``cc -O2`` +
    an empty ``config.h`` — SURVEY §4's differential-test recipe)."""
    ref_src = REFERENCE_DIR / "src"
    if not ref_src.is_dir():
        pytest.skip("reference sources not available")
    import subprocess

    build = tmp_path_factory.mktemp("refbuild")
    (build / "config.h").write_text("")
    exe = build / "bjxa-ref"
    sources = ["bjxa.c", "bjxa_decode.c", "bjxa_encode.c", "libbjxa.c"]
    subprocess.run(
        ["cc", "-O2", f"-I{build}", f"-I{ref_src}", "-o", str(exe)]
        + [str(ref_src / s) for s in sources],
        check=True,
        capture_output=True,
    )
    return exe

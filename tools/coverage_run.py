"""Line-coverage runner for the bjxa_tpu package (no external deps).

The reference makes measured coverage a first-class goal (100% of the C
library, ``README.rst:166``, via ``lcov.am``).  This environment has no
coverage.py/pytest-cov, so this tool implements the same measurement on
CPython 3.12's ``sys.monitoring`` (PEP 669): LINE events are recorded
once per (code object, line) and then disabled, so steady-state overhead
is near zero; executable-line universes come from walking each module's
code objects (``co_lines``), the same definition lcov uses.

Usage:
    python tools/coverage_run.py [--append] [pytest args...]
    # e.g. python tools/coverage_run.py -q --slow tests/

``--append`` merges into an existing ``coverage.json`` instead of
replacing it — used to combine several partial passes.
Subprocess workers (the multi-process distributed tests) report their
hits through ``BJXA_COV_DIR``, which this runner exports and merges.

Prints a per-file table plus a total, and writes ``coverage.json``.
Lines marked ``# pragma: no cover`` (or inside a block whose header is
marked) are excluded, mirroring lcov's LCOV_EXCL.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import covlib  # noqa: E402

REPO = covlib.REPO
PKG = covlib.PKG


def _executable_lines(path: str) -> set[int]:
    """All statement lines of a module, from its compiled code objects."""
    with open(path, "r") as f:
        src = f.read()
    lines: set[int] = set()
    stack = [compile(src, path, "exec")]
    while stack:
        code = stack.pop()
        for _, _, ln in code.co_lines():
            # line 0 is the module-prologue RESUME, never a real statement
            if ln:
                lines.add(ln)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    # drop doc/pragma-excluded lines
    src_lines = src.splitlines()
    excl = {
        i + 1
        for i, text in enumerate(src_lines)
        if "pragma: no cover" in text
    }
    # a pragma on a block header (def/if/class...) excludes the block
    import ast

    tree = ast.parse(src)
    for node in ast.walk(tree):
        if hasattr(node, "lineno") and node.lineno in excl:
            end = getattr(node, "end_lineno", node.lineno)
            lines -= set(range(node.lineno, end + 1))
    return lines - excl


def main() -> int:
    # run as a script, sys.path[0] is tools/ — the tests need the repo root
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    args = sys.argv[1:]
    append = "--append" in args
    if append:
        args = [a for a in args if a != "--append"]

    cov_dir = tempfile.mkdtemp(prefix="bjxa-cov-")
    os.environ["BJXA_COV_DIR"] = cov_dir

    covlib.start()

    import pytest

    rc = pytest.main(args or ["-q", "tests/"])

    covlib.stop()
    covered = {k: set(v) for k, v in covlib.covered.items()}

    # merge subprocess workers' hits
    for name in os.listdir(cov_dir):
        with open(os.path.join(cov_dir, name)) as f:
            for path, lines in json.load(f).items():
                covered.setdefault(path, set()).update(lines)

    out_path = os.path.join(REPO, "coverage.json")
    if append and os.path.exists(out_path):
        with open(out_path) as f:
            prior = json.load(f)
        for rel, info in prior.get("files", {}).items():
            path = os.path.join(REPO, rel)
            covered.setdefault(path, set()).update(info.get("hit_lines", []))

    rows = []
    tot_cov = tot_all = 0
    for root, _dirs, files in os.walk(PKG):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            exe = _executable_lines(path)
            hit = covered.get(path, set()) & exe
            rows.append(
                (
                    os.path.relpath(path, REPO),
                    sorted(hit),
                    len(exe),
                    sorted(exe - hit),
                )
            )
            tot_cov += len(hit)
            tot_all += len(exe)

    rows.sort(key=lambda r: (len(r[1]) / r[2] if r[2] else 1.0))
    print()
    print(f"{'file':<44} {'lines':>7} {'hit':>6} {'cov%':>6}  missing")
    for path, hit, total, missing in rows:
        pct = 100.0 * len(hit) / total if total else 100.0
        miss = ",".join(map(str, missing[:12])) + (
            ",..." if len(missing) > 12 else ""
        )
        print(f"{path:<44} {total:>7} {len(hit):>6} {pct:>5.1f}%  {miss}")
    total_pct = 100.0 * tot_cov / tot_all if tot_all else 100.0
    print(f"\nTOTAL {tot_cov}/{tot_all} = {total_pct:.1f}% line coverage")

    with open(out_path, "w") as f:
        json.dump(
            {
                "total_pct": round(total_pct, 2),
                "covered": tot_cov,
                "executable": tot_all,
                "files": {
                    p: {
                        "hit": len(h),
                        "lines": t,
                        "hit_lines": h,
                        "missing": m,
                    }
                    for p, h, t, m in rows
                },
            },
            f,
            indent=1,
        )
    print("wrote coverage.json" + (" (merged)" if append else ""))
    return int(rc)


if __name__ == "__main__":
    raise SystemExit(main())

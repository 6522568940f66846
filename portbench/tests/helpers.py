"""Tiny copies of the benchmark for CPU tests: the same files, with the
configurations cut to sizes a CPU runs in seconds."""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"

TINY_SUMMA = dict(grid=4, block=30)


def make_tree(dst: pathlib.Path) -> pathlib.Path:
    """A checkout at ``dst``: portbench and BENCHMARK.json copied, src
    linked, every configuration cut to a tiny size (blocks of 30, ragged
    as the full size is)."""
    shutil.copytree(BENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "src").symlink_to(REPO / "src")
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **TINY_SUMMA}))
    return dst


def run_cell(root: pathlib.Path, cell: str, *, seed: int = 2 ** 31 + 11,
             seconds: float = 2.0, extra=(), patch: str = ""):
    """Run one cell on the CPU in a fresh process; ``patch`` is Python run
    first (with the program importable) to break the timed path.  Returns
    (exit code, the result line's object or None, standard error)."""
    args = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0", "--device", "cpu", *extra]
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]
        sys.argv = ["portbench/run.py"] + {args!r}
    """) + textwrap.dedent(patch) + textwrap.dedent(f"""
        runpy.run_path({str(root / 'portbench' / 'run.py')!r},
                       run_name="__main__")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    last = p.stdout.strip().splitlines()[-1:] if p.stdout.strip() else []
    return p.returncode, (json.loads(last[0]) if last else None), p.stderr

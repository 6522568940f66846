"""On a machine with a card: a short run of each cell, through the
command the benchmark runs, is correct and reports its metrics."""
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import REPO

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_a_short_run_of_each_cell(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", str(2 ** 31 + 5), "--seconds", "5",
                        "--trace", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)

"""Percentiles and the window's arithmetic: a stall inside the window
moves the product rate of the cell it lands in."""
import numpy as np
import pytest

from portbench.harness.stats import median, percentile
from portbench.tests.helpers import make_tree, run_cell


def test_percentile_matches_numpy():
    rs = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = rs.exponential(size=n).tolist()
        for q in (0, 50, 90, 99, 100):
            assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert percentile([], 90) is None
    assert median([3.0, 1.0, 2.0]) == 2.0


STALL_SUMMA = """
import time
import repro_torch.core as _core
_run, _n = _core.abft_summa, [0]
def _stalled(*a, **k):
    _n[0] += 1
    if _n[0] == {at}:
        time.sleep({s})
    return _run(*a, **k)
_core.abft_summa = _stalled
"""


def _pair(root, cell, patch, seconds):
    rc0, clean, err0 = run_cell(root, cell, seconds=seconds)
    rc1, stalled, err1 = run_cell(root, cell, seconds=seconds, patch=patch)
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    assert clean["correct"] and stalled["correct"]
    return clean["metrics"], stalled["metrics"]


@pytest.mark.parametrize("cell,warm", [("summa-g8-nloc3000.clean", 1),
                                       ("summa-g8-nloc3000.kill-flip", 3)])
def test_a_stall_moves_the_product_rate(tmp_path, cell, warm):
    root = make_tree(tmp_path)
    # the stall lands on the window's second product, after the warm-up's
    clean, stalled = _pair(root, cell, STALL_SUMMA.format(at=warm + 2,
                                                          s=1.0), 1.0)
    assert stalled["ft_gemm_tflops"]["value"] \
        < 0.7 * clean["ft_gemm_tflops"]["value"]

"""The comparison that decides ``correct`` fails its control and the
faults a cell can have, at a size a test run holds.

The control is the reference one precision down (TF32) in the program's
place.  The faults break the timed path underneath a whole run: a SUMMA
step that leaves its state unchanged, a product's answer altered where it
is produced, and the recovery from two lost processes left out (a fault of
one kind of product, which the sample kept for the comparison has to
hold).  The limits are the configuration's own."""
import pytest

from portbench.tests.helpers import make_tree, run_cell

CLEAN = "summa-g8-nloc3000.clean"
KILL_FLIP = "summa-g8-nloc3000.kill-flip"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("tree"))


def _verdict(root, cell, **kw):
    rc, out, err = run_cell(root, cell, **kw)
    assert rc == 0, err[-3000:]
    return out


@pytest.mark.parametrize("cell", [CLEAN, KILL_FLIP])
def test_the_program_passes(root, cell):
    out = _verdict(root, cell, seconds=1.5)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", [CLEAN, KILL_FLIP])
def test_the_control_fails(root, cell):
    out = _verdict(root, cell, seconds=0.5, extra=["--control"])
    assert out["correct"] is False, out["checks"]


SKIP_A_STEP = """
import importlib
import torch as _torch
_s = importlib.import_module("repro_torch.core.summa")
class _T:
    n = 0
    def __getattr__(self, name):
        return getattr(_torch, name)
    def matmul(self, a, b):
        _T.n += 1
        out = _torch.matmul(a, b)
        return out * 0 if _T.n % 4 == 2 else out    # this step is lost
_s.torch = _T()
"""

ALTER_ANSWER = """
import repro_torch.core as _core
_strip = _core.strip
def _altered(c, *a):
    out = _strip(c, *a).clone()
    out[3, 5] += 1.0
    return out
_core.strip = _altered
"""

SKIP_DOUBLE_RECOVERY = """
import importlib
import repro_torch.core as _core
_s = importlib.import_module("repro_torch.core.summa")
_run, _recover, _two = _core.abft_summa, _s._recover_line, [False]
def _summa(*a, failure=None, **k):
    _two[0] = isinstance(failure, _core.MultiFailureEvent)
    return _run(*a, failure=failure, **k)
def _line(*a, **k):
    if not _two[0]:                # two lost processes stay lost
        return _recover(*a, **k)
_core.abft_summa, _s._recover_line = _summa, _line
"""


@pytest.mark.parametrize("cell,patch", [
    (CLEAN, SKIP_A_STEP), (CLEAN, ALTER_ANSWER),
    (KILL_FLIP, SKIP_A_STEP), (KILL_FLIP, SKIP_DOUBLE_RECOVERY)],
    ids=["clean-step-unchanged", "clean-answer-altered",
         "kill-flip-step-unchanged", "kill-flip-double-recovery-left-out"])
def test_a_broken_timed_path_is_not_correct(root, cell, patch):
    out = _verdict(root, cell, seconds=1.0, patch=patch)
    assert out["correct"] is False, out["checks"]

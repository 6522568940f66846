"""The generator: the same seed gives the same work; another seed the
same amounts of work in another order; large seeds work."""
import json

import pytest

from portbench.harness.traffic import product_faults
from portbench.tests.helpers import BENCH


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_faults_come_in_blocks_of_every_kind():
    fault = product_faults(_mix("kill-flip"), 8, 1, 2 ** 31 + 1)
    kinds = [fault(i).kind for i in range(40)]
    for b in range(10):
        assert sorted(kinds[4 * b:4 * b + 4]) == ["flip", "kill", "kill2",
                                                  "none"]
    for i in range(40):
        f = fault(i)
        assert 0 <= f.step < 8
        if f.kind == "kill2":
            (r1, c1), (r2, c2) = f.where
            assert r1 != r2 and c1 != c2
        if f.kind == "flip":
            (r, c), = f.where
            assert r < 7 and c < 7 and f.delta in (1e2, 1e3, 1e4, 1e5)
    clean = product_faults(_mix("clean"), 8, 1, 3)
    assert {clean(i).kind for i in range(20)} == {"none"}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 977, 2 ** 40 + 3])
def test_the_same_seed_gives_the_same_faults(seed):
    a = product_faults(_mix("kill-flip"), 8, 1, seed)
    b = product_faults(_mix("kill-flip"), 8, 1, seed)
    assert [a(i) for i in range(60)] == [b(i) for i in range(60)]


def test_another_seed_orders_the_same_blocks_otherwise():
    a = product_faults(_mix("kill-flip"), 8, 1, 1)
    b = product_faults(_mix("kill-flip"), 8, 1, 2 ** 40 + 3)
    ka, kb = ([f(i).kind for i in range(40)] for f in (a, b))
    assert ka != kb
    for i in range(0, 40, 4):
        assert sorted(ka[i:i + 4]) == sorted(kb[i:i + 4])
    assert [a(i) for i in range(40)] != [b(i) for i in range(40)]


def test_an_unknown_fault_kind_is_refused():
    with pytest.raises(ValueError, match="unknown fault kinds"):
        product_faults(dict(faults={"none": 1, "melt": 1}), 8, 1, 0)

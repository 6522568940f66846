"""Nothing the benchmark runs imports JAX, the JAX package or its
harness: every import under portbench/ (tests aside) by its top-level name,
compared whole, and a run's own look at ``sys.modules``."""
import ast
import importlib.util
import pathlib

import pytest

from portbench.tests.helpers import BENCH, make_tree, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _run_module():
    spec = importlib.util.spec_from_file_location("pb_run",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_source_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    seen = {}
    for p in files:
        for name in _imports(p):
            seen.setdefault(name.split(".")[0], []).append(p.name)
    assert not FORBIDDEN & set(seen), {k: seen[k] for k in
                                       FORBIDDEN & set(seen)}
    assert "repro_torch" in seen          # the port is what is imported


def test_forbidden_names_are_compared_whole(monkeypatch):
    run = _run_module()
    assert set(run.FORBIDDEN) == FORBIDDEN
    import sys
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_loaded() == ["repro"]


def test_a_run_refuses_when_the_jax_package_was_loaded(tmp_path):
    root = make_tree(tmp_path)
    # a stand-in module named as the JAX package, loaded before the run
    patch = "import types; sys.modules['repro'] = types.ModuleType('repro')"
    rc, out, err = run_cell(root, "summa-g8-nloc3000.clean", seconds=0.5,
                            patch=patch)
    assert rc != 0 and out is None
    assert "['repro']" in err


@pytest.mark.parametrize("cell", ["summa-g8-nloc3000.clean",
                                  "summa-g8-nloc3000.kill-flip"])
def test_a_run_loads_no_jax(tmp_path, cell):
    rc, out, err = run_cell(make_tree(tmp_path), cell, seconds=1.0)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, out


def test_a_tree_without_the_program_exits_nonzero(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copytree(BENCH, tmp_path / "portbench")
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "summa-g8-nloc3000.clean", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and not p.stdout.strip()

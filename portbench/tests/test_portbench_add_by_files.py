"""A later change adds a cell, a configuration, a mix and a metric by new
files and new entries in BENCHMARK.json alone: no file of the harness is
edited, and the run finds each by its name."""
import hashlib
import json

from portbench.tests.helpers import make_tree, run_cell


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in (root / "portbench").rglob("*") if p.is_file()
        and "__pycache__" not in p.parts}


def test_a_cell_mix_config_and_metric_added_by_files(tmp_path):
    root = make_tree(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    # a new configuration: another grid, by a file of sizes
    cfg = json.loads((pb / "configs" / "summa-g8-nloc3000.json")
                     .read_text())
    cfg.update(grid=5, f=1, block=20, processes=25)
    (pb / "configs" / "dummy-g5.json").write_text(json.dumps(cfg))
    # a new mix: only bit-flips, by a file of parameters
    (pb / "traffic" / "dummy-flips.json").write_text(json.dumps(dict(
        loop="products", faults={"flip": 1}, flip_exp_min=3,
        flip_exp_max=4, operand_pool=2)))
    # a new metric: a reader of its own
    (pb / "metrics" / "answered_share.dummy.py").write_text(
        "def read(ctx):\n"
        "    r = ctx.record\n"
        "    return 100.0 * (r['attempted'] - r['failed']) / r['attempted']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="dummy-g5", source="a test", file="portbench/configs/"
        "dummy-g5.json", reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy-g5.flips", config="dummy-g5",
                                   traffic="dummy-flips", chips=1,
                                   why="a test"))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dummy-g5.flips")
    bench["end_to_end"].append(dict(
        name="answered_share.dummy", unit="%", better="higher", bound=0.01,
        source="host_clock", workloads=["dummy-g5.flips"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, out, err = run_cell(root, "dummy-g5.flips", seconds=1.0)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True
    got = out["metrics"]
    assert got["answered_share.dummy"]["value"] == 100.0
    assert {"ft_gemm_tflops", "setup_s"} <= set(got)
    assert "(flip, operands" in err and "(none, operands" not in err
    # the new metric stays out of the other cells
    rc, out, err = run_cell(root, "summa-g8-nloc3000.clean", seconds=0.5)
    assert rc == 0 and "answered_share.dummy" not in out["metrics"]
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "portbench/configs/dummy-g5.json",
        "portbench/traffic/dummy-flips.json",
        "portbench/metrics/answered_share.dummy.py"}

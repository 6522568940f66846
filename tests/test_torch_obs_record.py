"""The port's telemetry recorder (``repro_torch.launch.obs``) at smoke size
on the CPU, held to the reference's committed ``OBS_PR10.json``.

``record`` replays the reference's trace on the port's `PagedServeEngine`
clean and under two SDCs on the logits reduction and two page flips: the
fault steps, the event count and the outcome must be the artifact's — 4
complete fault lifecycles, 0 dropped events, 0 missed, every verdict
``bit_identical``.  The overhead gate (obs on vs off, 2 % budget) needs the
card's timings and runs in ``chip_smoke.py``; here `check` is held to every
gate on a recorded artifact with the overhead reading set aside.
"""
import copy
import json
import pathlib

import pytest
import torch

from repro_torch import obs
from repro_torch.launch import obs as lobs

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    paths = {k: d / name for k, name in (
        ("json", "obs.json"), ("jsonl", "obs.jsonl"),
        ("perfetto", "trace.json"), ("prom", "metrics.prom"))}
    argv = ["record", "--device", "cpu"]
    for k, p in paths.items():
        argv += [f"--{k}", str(p)]
    lobs.main(argv)
    return paths, json.loads(paths["json"].read_text())


def test_record_matches_reference_artifact(recorded):
    _, r = recorded
    ref = json.loads((ROOT / "OBS_PR10.json").read_text())
    assert r["schema"] == ref["schema"] == lobs.SCHEMA
    assert sorted(r) == sorted(ref)
    for k in ("traffic", "sdc_steps", "dram_steps"):
        assert r["config"][k] == ref["config"][k], k
    assert r["config"]["backend"] == "cpu"
    for k in ("n_events", "dropped_events", "n_lifecycles",
              "n_complete_lifecycles"):
        assert r[k] == ref[k], k
    assert r["n_complete_lifecycles"] == 4 and r["dropped_events"] == 0
    assert sorted(r["rung_timeline"]) == sorted(ref["rung_timeline"]) == \
        ["abft_inflight", "scrub:page_repair"]
    slo = r["slo_under_fault"]
    for k in ("faults_injected", "faults_detected", "faults_corrected",
              "faults_missed", "token_streams_identical"):
        assert slo[k] == ref["slo_under_fault"][k], k
    assert slo["faults_missed"] == 0 and slo["token_streams_identical"]
    assert [lc["verdict"]["verdict"] for lc in r["lifecycles"]] == \
        ["bit_identical"] * 4
    assert [lc["inject"]["surface"] for lc in r["lifecycles"]] == \
        [lc["inject"]["surface"] for lc in ref["lifecycles"]]
    ov = r["overhead"]
    assert ov["budget_pct"] == 2.0 and ov["repeats"] == 16
    # every replay of the clean trace is cut into its head, one interval a
    # decode step and its tail, in on/off pairs: 16 replays of 35 executed
    # steps, 36 intervals, 18 pairs each
    assert ov["pairs"] == 16 * 18
    assert ov["obs_on_s"] > 0 and ov["obs_off_s"] > 0
    assert ov["overhead_pct"] == pytest.approx(
        100.0 * (ov["obs_on_s"] / ov["obs_off_s"] - 1.0))


def test_check_keeps_every_gate(recorded):
    _, r = recorded
    good = copy.deepcopy(r)
    good["overhead"]["overhead_pct"] = 0.0    # the card's reading, set aside
    lobs.check(good)
    breaks = [
        ("dropped_events", 1),
        ("n_complete_lifecycles", 3),
        ("rung_timeline", {}),
    ]
    for key, val in breaks:
        bad = copy.deepcopy(good)
        bad[key] = val
        with pytest.raises(AssertionError):
            lobs.check(bad)
    for key, val in (("faults_missed", 1), ("token_streams_identical",
                                             False)):
        bad = copy.deepcopy(good)
        bad["slo_under_fault"][key] = val
        with pytest.raises(AssertionError):
            lobs.check(bad)
    bad = copy.deepcopy(good)
    bad["lifecycles"][0]["verdict"]["verdict"] = "diverged"
    with pytest.raises(AssertionError):
        lobs.check(bad)
    bad = copy.deepcopy(good)
    bad["overhead"]["overhead_pct"] = 2.5
    with pytest.raises(AssertionError, match="overhead"):
        lobs.check(bad)


def test_render_from_log_and_artifact(recorded, tmp_path, capsys):
    paths, r = recorded
    obs.export.validate_perfetto(json.loads(paths["perfetto"].read_text()))
    assert "repro_page_repairs_total" in paths["prom"].read_text()
    capsys.readouterr()
    lobs.main(["render", str(paths["jsonl"]), "--perfetto",
               str(tmp_path / "a.json")])
    out = capsys.readouterr().out
    assert f"{r['n_events']} events, 4/4 complete fault lifecycles" in out
    assert "| scrub:page_repair |" in out
    lobs.main(["render", str(paths["json"]), "--perfetto",
               str(tmp_path / "b.json"), "--prom", str(tmp_path / "m.prom")])
    assert json.loads((tmp_path / "b.json").read_text()) == r["perfetto"]
    assert (tmp_path / "m.prom").read_text() == r["metrics_prometheus"]
    with pytest.raises(SystemExit):
        lobs.main(["render", str(paths["jsonl"]), "--prom",
                   str(tmp_path / "x.prom")])


def test_record_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: record runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lobs.record(device="cuda")


def test_overhead_counts_a_cost_on_few_intervals(monkeypatch):
    """A bus that costs only on one interval in five (admissions,
    retirements) shows in the gated ratio of sums; the median of the
    paired ratios would hide it.  A fake replay of 19 decode steps: every
    interval takes 2 ms, and 6 ms more when the bus is on at every fifth."""
    import time as _time

    from repro_torch.serve import traffic

    def fake_run_trace(engine, trace, on_step=None):
        for step in range(20):
            if step:
                on_step(engine, step)
            _time.sleep(0.002)
            if obs.enabled() and step % 5 == 0:
                _time.sleep(0.006)

    monkeypatch.setattr(traffic, "run_trace", fake_run_trace)
    ov = lobs._overhead(lambda: None, [], repeats=4)
    assert ov["pairs"] == 4 * 10
    # 4 of the 20 intervals cost 6 ms more when on: over two replays the
    # summed on over the summed off is about (40 + 24) / 40 - 1 = +60 %;
    # the median pair, +0 %
    assert ov["overhead_pct"] > 15.0
    assert abs(ov["median_pair_pct"]) < 15.0
    assert not obs.enabled()

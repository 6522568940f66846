"""The port's chaos campaign (``repro_torch.chaos``, ``repro_torch.launch.
chaos``) held against the reference's (``repro.chaos``, ``repro.launch.
chaos``): the same fault spaces spec for spec, the same classification,
the same bit-flip model, the same artifact for the same rows, and the
kernel and layer drills of the default space giving the reference's
outcomes.  On the CPU the drills run the kernels' plain versions (kernel
#2's PyTorch twin and kernel #4's plain recurrence); ``chip_smoke.py``
runs the campaign on the H100 through the kernels.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.chaos.campaign as jcampaign
import repro.chaos.faults as jfaults
import repro.chaos.report as jreport
import repro_torch.chaos.campaign as campaign
import repro_torch.chaos.faults as faults
import repro_torch.chaos.report as report
from repro_torch.launch import chaos as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]

SPACES = {
    "smoke": lambda m: m.FaultSpace.smoke(),
    "default": lambda m: m.FaultSpace.default(),
    "traffic_smoke": lambda m: m.FaultSpace.traffic_smoke(),
    "episodes_smoke": lambda m: m.FaultSpace.episodes_smoke(),
    "episodes_default": lambda m: m.FaultSpace.episodes_default(),
    "cartesian": lambda m: m.FaultSpace.cartesian(),
    "cartesian_knobs": lambda m: m.FaultSpace.cartesian(
        kinds=("sdc_collective", "dram_params", "shard_loss"),
        workloads=("train", "serve", "solver", "traffic"), steps=(1, 3),
        shards=(0, 2), deltas=(1e4, -3e4), bits=(29, 30)),
    "poisson_sweep": lambda m: m.FaultSpace.poisson_sweep(
        (50.0, 150.0, 400.0), steps=12, workload="solver", seed=3),
    "sample": lambda m: m.FaultSpace.default().sample(9, seed=4),
}

# the ten kernel and layer specs of FaultSpace.default() the port drills
DRILLED = ("checksum_state_flip", "flash_state_flip", "norm_corruption",
           "gather_corruption")


def _drilled(spec) -> bool:
    return spec.workload == "train" and (
        spec.kind in DRILLED or (spec.kind == "sdc_collective"
                                 and spec.surface == "kernels.ops/acc_state"))


DEFAULT_TRAIN = [s for s in faults.FaultSpace.default().specs
                 if s.workload == "train"]
DRILL_SPECS = [s for s in DEFAULT_TRAIN if _drilled(s)]


# -- taxonomy parity ----------------------------------------------------------


def test_constants_match_reference():
    assert faults.KINDS == jfaults.KINDS
    assert faults.WORKLOADS == jfaults.WORKLOADS
    assert faults.RATE_KINDS == jfaults.RATE_KINDS
    assert faults._KIND_INFO == jfaults._KIND_INFO
    for kind in faults.KINDS:
        for wl in faults._KIND_INFO[kind]["workloads"]:
            assert faults.kind_surface(kind, wl) == \
                jfaults.kind_surface(kind, wl)


@pytest.mark.parametrize("space", sorted(SPACES))
def test_fault_space_matches_reference(space):
    mine, ref = SPACES[space](faults), SPACES[space](jfaults)
    assert mine.name == ref.name and len(mine) == len(ref)
    assert [s.name for s in mine] == [s.name for s in ref]
    assert [s.asdict() for s in mine] == [s.asdict() for s in ref]
    assert [e.asdict() for e in mine.episodes] == \
        [e.asdict() for e in ref.episodes]
    assert [[s.asdict() for s in e.resolved()] for e in mine.episodes] == \
        [[s.asdict() for s in e.resolved()] for e in ref.episodes]
    for s in mine:
        d = json.loads(json.dumps(s.asdict()))
        assert faults.FaultSpec.from_dict(dict(d, extra=1)) == s
        assert jfaults.FaultSpec.from_dict(d).asdict() == s.asdict()
    for e in mine.episodes:
        d = json.loads(json.dumps(e.asdict()))
        assert faults.Episode.from_dict(d) == e
        assert jfaults.Episode.from_dict(d).asdict() == e.asdict()


def test_fault_spec_validation_and_plans():
    with pytest.raises(ValueError):
        faults.FaultSpec(kind="nope", workload="train")
    with pytest.raises(ValueError):
        faults.FaultSpec(kind="flash_state_flip", workload="serve")
    with pytest.raises(ValueError):
        faults.Episode("e", "train", events=())
    sdc = faults.FaultSpec(kind="sdc_collective", workload="train", step=3,
                           shard=1, delta=-2.0)
    assert sdc.sdc_plan().events == ((3, 1, -2.0),)
    loss = faults.FaultSpec(kind="shard_loss", workload="train", step=4,
                            shard=2)
    assert loss.failure_plan().events == ((4, 2),)
    with pytest.raises(ValueError):
        loss.sdc_plan()
    with pytest.raises(ValueError):
        sdc.failure_plan()
    plan = faults.SDCPlan(((1, 0, 5.0), (1, 0, 5.0), (1, 2, 6.0)))
    assert plan.events_at(1) == ((0, 5.0), (2, 6.0))
    assert faults.SDCPlan.random(3, 10, 4, seed=2).events == \
        jfaults.SDCPlan.random(3, 10, 4, seed=2).events


# -- classification -----------------------------------------------------------

CLASSIFY = [
    (dict(injected=False, detected=False, corrected=False,
          end_state="bit_identical", promise="none"), "clean"),
    (dict(injected=False, detected=True, corrected=False,
          end_state="bit_identical", promise="none"), "false_alarm"),
    (dict(injected=True, detected=False, corrected=False,
          end_state="diverged", promise="tolerance"), "missed"),
    (dict(injected=True, detected=True, corrected=True,
          end_state="within_tol", promise="tolerance"), "corrected"),
    (dict(injected=True, detected=True, corrected=True,
          end_state="within_tol", promise="bit_identity"), "detected"),
    (dict(injected=True, detected=True, corrected=True,
          end_state="bit_identical", promise="bit_identity"), "corrected"),
    (dict(injected=True, detected=True, corrected=False,
          end_state="bit_identical", promise="tolerance"), "detected"),
    (dict(injected=True, detected=True, corrected=True,
          end_state="diverged", promise="tolerance"), "detected"),
    (dict(injected=True, detected=True, corrected=True,
          end_state="bit_identical", promise="none"), "detected"),
]

EPISODES = [
    ((["corrected", "absorbed"], True, 0), "corrected"),
    ((["corrected", "missed"], True, 0), "missed"),
    ((["skipped", "skipped"], True, 0), "skipped"),
    ((["corrected", "skipped"], True, 0), "corrected"),
    ((["corrected"], False, 0), "detected"),
    ((["corrected"], True, 1), "false_alarm"),
    ((["detected", "corrected"], True, 0), "detected"),
]


@pytest.mark.parametrize("mod", [campaign, jcampaign],
                         ids=["port", "reference"])
@pytest.mark.parametrize("signals,want", CLASSIFY)
def test_classify_truth_table(mod, signals, want):
    assert mod.classify(**signals) == want


@pytest.mark.parametrize("mod", [campaign, jcampaign],
                         ids=["port", "reference"])
@pytest.mark.parametrize("args,want", EPISODES)
def test_episode_outcome_truth_table(mod, args, want):
    outs, end_ok, fa = args
    assert mod.episode_outcome(outs, end_ok=end_ok, false_alarms=fa) == want


# -- the bit-flip fault model -------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("bit", [20, 28, 29, 30, 31])
def test_flip_bit_matches_reference(dtype, bit):
    rs = np.random.RandomState(bit)
    x = (rs.standard_normal(64).astype(np.float32) if dtype == "float32"
         else rs.randint(-1000, 1000, 64).astype(np.int32)).reshape(8, 8)
    idx = int(rs.randint(64))
    want = np.asarray(jfaults.flip_bit(jnp.asarray(x), idx, bit=bit))
    t = torch.from_numpy(x.copy())
    got = faults.flip_bit(t, idx, bit=bit)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(t.numpy(), x)          # the input is untouched
    assert np.count_nonzero(got.numpy().view(np.int32)
                            != x.view(np.int32)) == 1


def test_flip_bit_takes_32_bit_words_only():
    with pytest.raises(TypeError):
        faults.flip_bit(torch.zeros(4, dtype=torch.bfloat16), 0)
    with pytest.raises(ValueError):
        faults.flip_bit(torch.zeros(4), 0, bit=32)


# -- the artifact -------------------------------------------------------------


def _rows(mod):
    fr = mod.FaultResult
    return [
        fr(name="train:flash_state_flip:s1", workload="train",
           kind="flash_state_flip", surface="kernels.flash_attention",
           protected=True, promise="tolerance", outcome="corrected",
           detected=True, corrected=True, rung="flash:recompute_tile",
           recovery_latency_s=0.002, end_state="within_tol",
           max_abs_diff=3e-7, wall_s=0.5, spec={"kind": "flash_state_flip"},
           recovery_warm_s=0.001, recovery_compile_s=0.001),
        fr(name="train:checksum_state_flip:s1", workload="train",
           kind="checksum_state_flip", surface="kernels.ops/acc_state",
           protected=True, promise="tolerance", outcome="detected",
           detected=True, corrected=False, rung=None,
           recovery_latency_s=None, end_state="bit_identical",
           max_abs_diff=0.0, wall_s=0.2, spec={"kind": "x"}),
        fr(name="train:shard_loss:s3", workload="train", kind="shard_loss",
           surface="ckpt.diskless/shards", protected=True,
           promise="tolerance", outcome="skipped", detected=False,
           corrected=False, rung=None, recovery_latency_s=None,
           end_state="not_compared", max_abs_diff=None, wall_s=0.0,
           spec={"kind": "shard_loss"}, note="waits"),
        fr(name="episode:train:poisson250", workload="train",
           kind="episode", surface="episode/train", protected=True,
           promise="tolerance", outcome="missed", detected=False,
           corrected=False, rung=None, recovery_latency_s=None,
           end_state="diverged", max_abs_diff=None, wall_s=1.0,
           spec={"rate_per_1k": 250.0, "events": [1, 2]},
           episode="train:poisson250"),
        fr(name="train:clean_sweep:1x1:protected", workload="train",
           kind="clean_sweep", surface="dist.collectives/abft_psum",
           protected=True, promise="none", outcome="false_alarm",
           detected=True, corrected=False, rung=None,
           recovery_latency_s=None, end_state="bit_identical",
           max_abs_diff=0.0, wall_s=0.1),
    ]


def test_report_matches_reference(monkeypatch):
    """The same rows give the same artifact and markdown in both packages
    (each module's ledger reads one fixed registry here: the registries
    themselves differ while the port grows)."""
    ledger = [faults.Surface(name="state.params_at_rest", owner="x",
                             protected=False, note="n"),
              faults.Surface(name="serve.paged_kv/pages", owner="y",
                             protected=False, note="m")]
    for mod in (report, jreport):
        monkeypatch.setattr(mod, "ensure_registered", lambda: {})
        monkeypatch.setattr(mod, "uncovered_surfaces", lambda: ledger)
    meta = {"backend": "cpu"}
    mine = campaign.CampaignResult("default", _rows(campaign), meta)
    ref = jcampaign.CampaignResult("default", _rows(jcampaign), meta)
    assert report.SCHEMA == jreport.SCHEMA
    assert report.campaign_dict(mine) == jreport.campaign_dict(ref)
    assert report.render_markdown(mine) == jreport.render_markdown(ref)
    assert mine.to_dict() == ref.to_dict()


# -- registry -----------------------------------------------------------------


def test_registry_resolves_every_spec_surface():
    reg = faults.ensure_registered()
    flash = reg["kernels.flash_attention"]
    assert flash.protected and flash.promise == "tolerance"
    assert flash.kinds == ("flash_state_flip",)
    jflash = jfaults.ensure_registered()["kernels.flash_attention"]
    assert (flash.promise, flash.kinds, flash.note) == \
        (jflash.promise, jflash.kinds, jflash.note)
    for name in ("smoke", "default", "traffic_smoke"):
        for s in SPACES[name](faults):
            faults.get_surface(s.surface)
    for s in faults.uncovered_surfaces():
        assert s.note       # each names what it waits for


# -- the drills ---------------------------------------------------------------


def test_the_drilled_specs_are_the_ten_kernel_and_layer_specs():
    assert len(DEFAULT_TRAIN) == 19 and len(DRILL_SPECS) == 10
    kinds = [s.kind for s in DRILL_SPECS]
    assert kinds.count("checksum_state_flip") == 3
    assert kinds.count("sdc_collective") == 3
    assert kinds.count("flash_state_flip") == 2


def _ref_result(spec):
    jspec = jfaults.FaultSpec.from_dict(spec.asdict())
    runner = jcampaign.CampaignRunner(jfaults.FaultSpace("one", (jspec,)))
    try:
        return runner._run_spec(jspec)
    finally:
        runner._tmp.cleanup()


@pytest.mark.parametrize("spec", DRILL_SPECS, ids=lambda s: s.name)
def test_drill_matches_reference(spec):
    mine = campaign.CampaignRunner(faults.FaultSpace("one", (spec,)),
                                   device="cpu")._run_spec(spec)
    ref = _ref_result(spec)
    for key in ("name", "surface", "protected", "promise", "outcome",
                "detected", "corrected", "rung"):
        assert getattr(mine, key) == getattr(ref, key), key
    assert mine.end_state in ("bit_identical", "within_tol")
    if spec.kind != "flash_state_flip" and (
            spec.kind != "sdc_collective" or spec.variant == "int8"):
        # bit-exact by design: a state flip's untouched data, the int8
        # repair, a layer recompute
        assert mine.end_state == ref.end_state == "bit_identical"
        assert mine.max_abs_diff == 0.0
    else:
        # a float repair: within the promise's tolerance
        assert mine.max_abs_diff <= campaign.TrainConfig().tol
    assert mine.spec == spec.asdict() == ref.spec
    if spec.kind == "checksum_state_flip":
        # the flip hits the reference's column of the plain-sum row
        assert mine.note == ref.note
    if mine.rung is not None:
        assert mine.recovery_latency_s is not None


def test_drills_match_the_committed_campaign():
    """The specs of the default space that the reference's committed
    campaign recorded come out with its outcome, rung and end state."""
    events = {e["name"]: e for e in json.loads(
        (ROOT / "CAMPAIGN_PR7.json").read_text())["events"]}
    seen = 0
    for spec in DRILL_SPECS:
        if spec.name not in events:
            continue
        seen += 1
        want = events[spec.name]
        got = campaign.CampaignRunner(faults.FaultSpace("one", (spec,)),
                                      device="cpu")._run_spec(spec)
        assert (got.outcome, got.rung, got.end_state, got.surface) == \
            (want["outcome"], want["rung"], want["end_state"],
             want["surface"]), spec.name
    assert seen == 5


# the rows that skipped while the port ran one device: each now runs on the
# logical pod mesh (2, 2, 2) or serve mesh (4, 2) and is held to the
# reference's campaign on 8 devices (CAMPAIGN_PR7.json); the train and serve
# runtimes that run the other rows are held against the reference in
# tests/test_torch_chaos_ft.py
STILL_SKIPPED = ("serve:sdc_collective:s3:sh1:d-30000:seed1",
                 "train:shard_loss:s3:sh1:seed1",
                 "train:pod_loss:s3:diskless", "train:pod_loss:s3:disk:seed1",
                 "train:slow_pod:s1")
STILL_SKIPPED_EPISODES = ("train:dram+podloss", "train:pod_repeat")
PR7_EVENTS = json.loads((pathlib.Path(__file__).resolve().parents[1]
                         / "CAMPAIGN_PR7.json").read_text())["events"]


def _workload_rows(results, workload):
    return [(r.name, r.outcome, r.rung, r.end_state) for r in results
            if r.workload == workload]


def test_skipped_handlers_name_their_slice():
    """The solver workload runs row for row as the reference's one-device
    campaign runs it; the traffic workload's golden is a clean sweep
    (tests/test_torch_chaos_ft.py holds its rows to the reference).  The
    train and serve rows that skipped on one device until the pod paths
    were ported each run alone, at the campaign's own sizes, with the
    outcome, rung and end state of the reference's 8-device campaign
    (CAMPAIGN_PR7.json)."""
    runner = campaign.CampaignRunner(faults.FaultSpace.default(),
                                     device="cpu")
    res = runner.run(("solver", "traffic"))
    ref_runner = jcampaign.CampaignRunner(jfaults.FaultSpace.default())
    try:
        ref = ref_runner.run(("solver",))
    finally:
        ref_runner._tmp.cleanup()
    solver = _workload_rows(res.results, "solver")
    assert len(solver) == 29 and \
        solver == _workload_rows(ref.results, "solver")
    assert [r.outcome for r in res.results if r.workload == "solver"
            ].count("corrected") == 28
    assert [(r.name, r.outcome) for r in res.results
            if r.workload == "traffic"] == [
        ("traffic:clean_sweep:paged", "clean")]
    assert {r.name for r in res.results if r.kind == "clean_sweep"} == \
        {"solver:clean_sweep", "traffic:clean_sweep:paged"}
    assert sorted(r.name for r in res.results if r.spec and
                  r.kind not in ("episode", "clean_sweep")
                  and not r.episode) == sorted(
        s.name for s in faults.FaultSpace.default().specs
        if s.workload in ("solver", "traffic"))
    d, jd = res.to_dict(), ref.to_dict()
    assert d["summary"]["missed_anywhere"] == []
    assert d["summary"]["false_alarms"] == []
    assert d["episodes"]["not_corrected"] == []
    assert d["episodes"]["skipped"] == []
    assert [(e["name"], e["outcome"]) for e in d["episodes"]["episodes"]] \
        == [(e["name"], e["outcome"]) for e in jd["episodes"]["episodes"]]
    assert d["episodes"]["sustained_rate_at_parity"] == \
        jd["episodes"]["sustained_rate_at_parity"]
    assert d["episodes"]["sustained_rate_at_parity"]["solver"][
        "sustained_rate_per_1k"] == 400.0
    assert res.meta["solver"] == ref.meta["solver"]
    assert res.meta["backend"] == "cpu" and res.meta["n_devices"] == 1
    def key(r):
        return (r["name"], r["outcome"], r["rung"], r["end_state"]) \
            if isinstance(r, dict) else \
            (r.name, r.outcome, r.rung, r.end_state)

    pr7 = {e["name"]: key(e) for e in PR7_EVENTS}
    specs = {s.name: s for s in faults.FaultSpace.default().specs}
    for name in STILL_SKIPPED:
        got = runner._run_spec(specs[name])
        assert key(got) == pr7[name], got.note
    eps = {ep.name: ep for ep in faults.FaultSpace.default().episodes}
    for name in STILL_SKIPPED_EPISODES:
        rows = runner._run_episode(eps[name])
        want = [key(e) for e in PR7_EVENTS
                if e["name"].startswith(name + "::")
                or e["name"] == f"episode:{name}"]
        assert [key(r) for r in rows] == want, [r.note for r in rows]
        assert len(want) >= 3


def test_acc_plan_tiles_the_drill_exactly():
    """The kernel #2 drills run on the kernel's own exact tiling of 256^3,
    the plan chip_smoke.py holds the kernel to its plain version on."""
    plan = campaign.CampaignRunner._acc_plan(256, 256, 256)
    assert (plan.m, plan.k, plan.n) == (256, 256, 256)
    assert 256 % plan.bm == 0 and 256 % plan.bn == 0
    assert plan == campaign.CampaignRunner._acc_plan(256, 256, 256)


def test_compare_trees():
    a = {"x": torch.zeros(3), "y": torch.arange(3)}
    assert campaign._compare_trees(campaign._host(a), campaign._host(a),
                                   0.0) == ("bit_identical", 0.0)
    b = {"x": torch.tensor([0.0, 1e-3, 0.0]), "y": torch.arange(3)}
    assert campaign._compare_trees(campaign._host(b), campaign._host(a),
                                   1e-2) == ("within_tol",
                                             pytest.approx(1e-3))
    c = {"x": torch.tensor([float("nan"), 0, 0]), "y": torch.arange(3)}
    assert campaign._compare_trees(campaign._host(c), campaign._host(a),
                                   1e-2) == ("diverged", None)


# -- the CLI ------------------------------------------------------------------


def test_cli_smoke_on_cpu(tmp_path, capsys):
    out = tmp_path / "chaos.json"
    assert cli.main(["--device", "cpu", "--space", "smoke", "--workload",
                     "train", "--json", str(out), "--quiet"]) == 0
    d = json.loads(out.read_text())
    assert d["schema"] == jreport.SCHEMA and d["space"] == "smoke"
    smoke_train = [s for s in faults.FaultSpace.smoke().specs
                   if s.workload == "train"]
    # every smoke train spec runs on one device; the two smoke train
    # episodes' space is not this one, so nothing is skipped
    skipped = sorted(e["name"] for e in d["events"]
                     if e["outcome"] == "skipped" and e["spec"])
    assert skipped == []
    assert d["summary"]["by_outcome"]["corrected"] == sum(
        1 for s in smoke_train if s.kind != "checksum_state_flip")
    assert d["summary"]["missed_anywhere"] == []
    assert d["summary"]["false_alarms"] == []
    assert "# Chaos campaign `smoke`" in capsys.readouterr().out
    # the replay path rebuilds the same space from the artifact
    space = cli.space_from_artifact(d)
    assert [s.name for s in space] == [s.name for s in smoke_train]
    # the reference's gate, unchanged: the uncovered ledger is empty (the
    # pod surface, ft.runtime/topology, is protected by the ported pod
    # paths), so the gate passes
    assert d["uncovered_surfaces"] == []
    assert cli.main(["--device", "cpu", "--space", "smoke", "--workload",
                     "train", "--check", "--quiet"]) == 0


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = faults.FaultSpace.smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign.CampaignRunner(space)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--space", "smoke", "--workload", "train", "--quiet"])
    assert campaign.CampaignRunner(space, device="cpu").device.type == "cpu"

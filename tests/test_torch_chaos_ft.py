"""The port's chaos campaign over the train and serve runtimes held against
the reference's campaign: the SDC, DRAM, shard-loss, pod-loss and
slow-pod drills of the protected train step, `ElasticRuntime` and the
protected serving engine, their episodes and clean sweeps.

A live test runs both packages' `CampaignRunner` on one spec of each kind
and one episode of each workload, the reference on its one device; the
port's pod-mesh rows there (shard loss runs on the logical pod mesh, as
the reference's does with 8 devices) are held to ``CAMPAIGN_PR7.json``,
the reference's campaign on 8 devices.  The whole-campaign test holds the
port's default space over ``("train", "serve")`` to that file's rows
(`REF_ROWS`).  Outcome, rung
and end state must be equal: the kind of agreement the campaign promises,
since the port draws its own random weights.  The traffic tests hold the
port's paged serving workload to the reference's on
`FaultSpace.traffic_smoke()` and its clean sweep, row for row.
"""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

import repro.chaos.campaign as jcampaign
import repro.chaos.faults as jfaults
import repro_torch.chaos.campaign as campaign
import repro_torch.chaos.faults as faults
from repro_torch.launch import chaos as cli

# name, outcome, rung, end state of every row of the reference's campaign
# over the default space's train and serve workloads on its 8 devices (pod
# mesh 2 x 2 x 2, serve mesh 4 x 2), in its order: CAMPAIGN_PR7.json's 69
# train and serve rows (held to the file itself below), with the five
# dtype-variant kernel rows the space has gained since at the reference's
# one-device values (they run no mesh)
REF_ROWS = [
    ("train:sdc_collective:s2", "corrected", "abft_inflight", "within_tol"),
    ("train:checksum_state_flip:s1", "detected", None, "bit_identical"),
    ("train:checksum_state_flip:s1:bf16:seed1", "detected",
     None, "bit_identical"),
    ("train:sdc_collective:s1:b20:int8", "corrected",
     "kernel:masked_recompute", "bit_identical"),
    ("train:flash_state_flip:s1", "corrected",
     "flash:recompute_tile", "within_tol"),
    ("train:norm_corruption:s2", "corrected", "recompute", "bit_identical"),
    ("train:gather_corruption:s2", "corrected", "recompute", "bit_identical"),
    ("train:dram_params:s2", "corrected", "scrub:diskless", "bit_identical"),
    ("train:dram_opt_state:s2:b29", "corrected",
     "scrub:diskless", "bit_identical"),
    ("train:shard_loss:s3", "corrected", "diskless", "within_tol"),
    ("serve:sdc_collective:s1", "corrected", "abft_inflight", "bit_identical"),
    ("serve:dram_kv_cache:s2", "corrected",
     "scrub:kv_repair", "bit_identical"),
    ("train:sdc_collective:s4:d-30000:seed1", "corrected",
     "abft_inflight", "within_tol"),
    ("serve:sdc_collective:s3:sh1:d-30000:seed1", "corrected",
     "abft_inflight", "bit_identical"),
    ("serve:dram_params:s0", "corrected", "scrub:restore", "bit_identical"),
    ("train:flash_state_flip:s2:l:seed1", "corrected",
     "flash:recompute_tile", "within_tol"),
    ("train:checksum_state_flip:s2:b29:int8:seed2", "detected",
     None, "bit_identical"),
    ("train:sdc_collective:s2:bf16:seed2", "corrected",
     "kernel:masked_recompute", "within_tol"),
    ("train:sdc_collective:s2:b28:seed3", "corrected",
     "kernel:masked_recompute", "within_tol"),
    ("train:shard_loss:s3:sh1:seed1", "corrected", "diskless", "within_tol"),
    ("train:pod_loss:s3:diskless", "corrected",
     "elastic:diskless", "within_tol"),
    ("train:pod_loss:s3:disk:seed1", "corrected",
     "elastic:disk", "within_tol"),
    ("train:slow_pod:s1", "corrected", "demote:disk", "within_tol"),
    ("train:sdc+dram_burst::e0:sdc_collective", "corrected",
     "abft_inflight", "not_compared"),
    ("train:sdc+dram_burst::e1:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("train:sdc+dram_burst::e2:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("train:sdc+dram_burst::e3:dram_opt_state", "corrected",
     "scrub:diskless", "not_compared"),
    ("episode:train:sdc+dram_burst", "corrected",
     "abft_inflight+scrub:diskless", "within_tol"),
    ("serve:sdc+kv_dram::e0:sdc_collective", "corrected",
     "abft_inflight", "not_compared"),
    ("serve:sdc+kv_dram::e1:dram_kv_cache", "corrected",
     "scrub:kv_repair", "not_compared"),
    ("serve:sdc+kv_dram::e2:dram_params", "corrected",
     "scrub:restore", "not_compared"),
    ("episode:serve:sdc+kv_dram", "corrected",
     "abft_inflight+scrub:kv_repair+scrub:restore", "bit_identical"),
    ("train:poisson250::e0:shard_loss", "corrected",
     "diskless", "not_compared"),
    ("episode:train:poisson250", "corrected", "diskless", "bit_identical"),
    ("serve:poisson250::e0:dram_kv_cache", "corrected",
     "scrub:kv_repair", "not_compared"),
    ("serve:poisson250::e1:sdc_collective", "corrected",
     "abft_inflight", "not_compared"),
    ("episode:serve:poisson250", "corrected",
     "abft_inflight+scrub:kv_repair", "bit_identical"),
    ("train:dram+podloss::e0:dram_params", "absorbed", None, "not_compared"),
    ("train:dram+podloss::e1:pod_loss", "corrected",
     "elastic:diskless", "not_compared"),
    ("train:dram+podloss::e2:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("episode:train:dram+podloss", "corrected",
     "elastic:diskless+scrub:diskless", "within_tol"),
    ("train:pod_repeat::e0:pod_loss", "corrected",
     "elastic:diskless", "not_compared"),
    ("train:pod_repeat::e1:pod_loss", "corrected",
     "elastic:diskless", "not_compared"),
    ("episode:train:pod_repeat", "corrected",
     "elastic:diskless", "within_tol"),
    ("train:poisson125::e0:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("episode:train:poisson125", "corrected",
     "scrub:diskless", "bit_identical"),
    ("train:poisson250::e0:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("train:poisson250::e1:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("train:poisson250::e2:shard_loss", "corrected",
     "diskless", "not_compared"),
    ("train:poisson250::e3:sdc_collective", "corrected",
     "abft_inflight", "not_compared"),
    ("train:poisson250::e4:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("train:poisson250::e5:dram_params", "corrected",
     "scrub:diskless", "not_compared"),
    ("episode:train:poisson250", "corrected",
     "abft_inflight+diskless+scrub:diskless", "within_tol"),
    ("train:poisson500::e0:sdc_collective", "corrected",
     "abft_inflight", "not_compared"),
    ("train:poisson500::e1:dram_opt_state", "corrected",
     "scrub:diskless", "not_compared"),
    ("train:poisson500::e2:shard_loss", "corrected",
     "diskless", "not_compared"),
    ("train:poisson500::e3:shard_loss", "corrected",
     "diskless", "not_compared"),
    ("train:poisson500::e4:sdc_collective", "corrected",
     "abft_inflight", "not_compared"),
    ("train:poisson500::e5:dram_opt_state", "corrected",
     "scrub:diskless", "not_compared"),
    ("episode:train:poisson500", "corrected",
     "abft_inflight+diskless+scrub:diskless", "within_tol"),
    ("serve:poisson125::e0:dram_params", "corrected",
     "scrub:restore", "not_compared"),
    ("episode:serve:poisson125", "corrected",
     "scrub:restore", "bit_identical"),
    ("serve:poisson250::e0:dram_params", "corrected",
     "scrub:restore", "not_compared"),
    ("serve:poisson250::e1:dram_params", "corrected",
     "scrub:restore", "not_compared"),
    ("episode:serve:poisson250", "corrected",
     "scrub:restore", "bit_identical"),
    ("train:clean_sweep:1x1:plain", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:plain:7st", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:protected", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:protected:9st", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:scrub", "clean", None, "bit_identical"),
    ("train:clean_sweep:2x2x2:plain", "clean", None, "bit_identical"),
    ("train:clean_sweep:2x2x2:plain:7st", "clean", None, "bit_identical"),
    ("serve:clean_sweep:4x2", "clean", None, "bit_identical"),
    ("serve:clean_sweep:4x2xscrub", "clean", None, "bit_identical"),
]
REF_BY_OUTCOME = {"corrected": 61, "absorbed": 1, "detected": 3,
                  "missed": 0, "false_alarm": 0, "clean": 9, "skipped": 0}
REF_EPISODES = {"corrected": 11}

PR7_EVENTS = json.loads(
    (pathlib.Path(__file__).resolve().parents[1] / "CAMPAIGN_PR7.json")
    .read_text())["events"]
PR7 = {e["name"]: e for e in PR7_EVENTS}

LIVE_SPECS = ("train:sdc_collective:s2", "train:dram_params:s2",
              "train:dram_opt_state:s2:b29", "train:shard_loss:s3",
              "serve:sdc_collective:s1", "serve:dram_kv_cache:s2",
              "serve:dram_params:s0")
LIVE_EPISODES = ("train:poisson125", "serve:sdc+kv_dram")


def _space(mod):
    full = mod.FaultSpace.default()
    return mod.FaultSpace(
        "live", tuple(s for s in full.specs if s.name in LIVE_SPECS),
        episodes=tuple(e for e in full.episodes if e.name in LIVE_EPISODES))


def _key(r):
    return (r.name, r.outcome, r.rung, r.end_state, r.detected)


def test_live_rows_match_reference(monkeypatch):
    """Both packages' runners on one spec of each drilled kind and one
    episode of each workload: every row (the episodes' event rows and the
    clean sweeps of the goldens they ran included) equal in outcome, rung,
    end state and detection.  The reference runs on one device here, so
    its shard loss and serve sweeps run on 1 x 1; the port's run on the
    logical pod mesh (2, 2, 2) and serve mesh (4, 2), and those rows are
    held to the reference's 8-device campaign (CAMPAIGN_PR7.json)."""
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    assert len(jax.devices()) == 1
    want = jcampaign.CampaignRunner(_space(jfaults)).run(("train", "serve"))
    got = campaign.CampaignRunner(_space(faults), device="cpu").run(
        ("train", "serve"))
    mesh_rows = {"train:shard_loss:s3": "train:shard_loss:s3",
                 "train:clean_sweep:2x2x2:plain":
                     "train:clean_sweep:1x1:plain",
                 "serve:clean_sweep:4x2": "serve:clean_sweep:1x1",
                 "serve:clean_sweep:4x2xscrub":
                     "serve:clean_sweep:1x1xscrub"}
    got_keys = [_key(r) for r in got.results if r.name not in mesh_rows]
    want_keys = [_key(r) for r in want.results
                 if r.name not in mesh_rows.values()]
    assert got_keys == want_keys
    for r in got.results:
        if r.name in mesh_rows:
            w = PR7[r.name]
            assert (r.outcome, r.rung, r.end_state, r.detected) == (
                w["outcome"], w["rung"], w["end_state"], w["detected"]), \
                r.name
    assert sorted(mesh_rows) == sorted(
        r.name for r in got.results if r.name in mesh_rows)
    assert len(got.results) == 7 + 2 + 4 + 1 + 5
    assert not any(r.outcome in ("missed", "false_alarm", "skipped")
                   for r in got.results)


def test_flip_helpers_hit_the_reference_bits():
    """`_flip_state_leaf` draws over the reference's stacked layout, so the
    same spec flips the same bit of the same leaf in both packages."""
    from repro.train.step import StepOptions, init_state
    from repro.configs.base import smoke_config as jsmoke
    from repro_torch.configs.base import smoke_config as tsmoke
    from repro_torch.convert import state_from_jax
    from repro_torch.ft.runtime import stack_view
    from torch_port_helpers import to_np
    js = jax.tree.map(np.asarray, init_state(
        jax.random.PRNGKey(0), jsmoke("qwen2-0.5b"), StepOptions()))
    js["opt"] = jax.tree.map(lambda x: x + 0.5 if x.dtype == np.float32
                             else x, js["opt"])
    ts = state_from_jax(js, tsmoke("qwen2-0.5b"))
    for seed in range(6):
        for kind, group in (("dram_params", "params"),
                            ("dram_opt_state", "opt")):
            spec_j = jfaults.FaultSpec(kind=kind, workload="train",
                                       seed=seed, bit=29)
            spec_t = faults.FaultSpec(kind=kind, workload="train",
                                      seed=seed, bit=29)
            fj, nj = jcampaign._flip_state_leaf(js, group, spec_j)
            ft, nt = campaign._flip_state_leaf(ts, group, spec_t)
            assert nt == nj
            for a, b in zip(jax.tree.leaves(fj[group]),
                            jax.tree.leaves(stack_view(ft[group], 1))):
                assert np.array_equal(to_np(b).reshape(np.shape(a)),
                                      np.asarray(a))


def test_whole_campaign_matches_reference_rows(tmp_path):
    """The port's default-space campaign over train and serve through the
    CLI: every row, by_outcome and the episode counts as the reference's
    8-device run (CAMPAIGN_PR7.json, row for row where it has the row);
    nothing skips."""
    out = tmp_path / "both.json"
    assert cli.main(["--device", "cpu", "--space", "default", "--workload",
                     "both", "--json", str(out), "--quiet"]) == 0
    d = json.loads(out.read_text())
    got = [(e["name"], e["outcome"], e["rung"], e["end_state"])
           for e in d["events"]]
    assert got == REF_ROWS
    pr7 = [(e["name"], e["outcome"], e["rung"], e["end_state"])
           for e in PR7_EVENTS if e["workload"] in ("train", "serve")]
    assert [r for r in got if r[0] in PR7] == pr7
    assert len(pr7) == 69
    assert d["summary"]["by_outcome"] == REF_BY_OUTCOME
    assert {k: v for k, v in d["episodes"]["by_outcome"].items() if v} == \
        REF_EPISODES
    assert d["summary"]["missed_anywhere"] == []
    assert d["summary"]["false_alarms"] == []
    assert not [e for e in d["events"] if e["outcome"] == "skipped"]
    assert d["meta"]["serve"]["slots"] == 4 and d["meta"]["train"]["steps"] \
        == 6
    # --steps overrides the train workload's horizon
    out2 = tmp_path / "steps.json"
    assert cli.main(["--device", "cpu", "--space", "smoke", "--workload",
                     "train", "--steps", "4", "--json", str(out2),
                     "--quiet"]) == 0
    d2 = json.loads(out2.read_text())
    assert d2["meta"]["train"]["steps"] == 4
    assert {e["name"] for e in d2["events"] if e["kind"] == "clean_sweep"} \
        >= {"train:clean_sweep:1x1:protected"}


# -- the traffic workload (paged engine under an open-loop trace) ------------

TRAFFIC_ROWS = [
    ("traffic:sdc_collective:s3", "corrected", "abft_inflight"),
    ("traffic:sdc_collective:s7:d-30000:seed1", "corrected",
     "abft_inflight"),
    ("traffic:dram_kv_cache:s5", "corrected", "scrub:page_repair"),
    ("traffic:dram_kv_cache:s9:pg1:b29", "corrected", "scrub:page_repair"),
    ("traffic:dram_params:s4", "corrected", "scrub:restore"),
    ("traffic:clean_sweep:paged", "clean", None),
]


def _traffic_key(r):
    return (r.name, r.outcome, r.rung, r.end_state, r.detected, r.corrected)


def test_traffic_rows_match_reference(monkeypatch):
    """Both packages' runners on `FaultSpace.traffic_smoke()` and the
    traffic sweep: every row equal in outcome, detection, correction, rung
    and end state.  The reference's traffic engine builds its default
    one-device mesh, whose axes are made ``Auto`` here (on this jax the
    default ``Explicit`` axes reject its embedding gather)."""
    make_mesh = jax.make_mesh

    def auto_mesh(shape, names, **kw):
        kw.setdefault("axis_types",
                      (jax.sharding.AxisType.Auto,) * len(names))
        return make_mesh(shape, names, **kw)

    monkeypatch.setattr(jax, "make_mesh", auto_mesh)
    want = jcampaign.CampaignRunner(
        jfaults.FaultSpace.traffic_smoke()).run(("traffic",))
    got = campaign.CampaignRunner(faults.FaultSpace.traffic_smoke(),
                                  device="cpu").run(("traffic",))
    assert [_traffic_key(r) for r in got.results] == \
        [_traffic_key(r) for r in want.results]
    assert [(r.name, r.outcome, r.rung) for r in got.results] == \
        TRAFFIC_ROWS
    assert all(r.end_state == "bit_identical" for r in got.results)
    # the same executed steps fire, the same pages are repaired
    for g, w in zip(got.results, want.results):
        if g.kind == "dram_kv_cache":
            assert g.note.split("; ")[0] == w.note.split("; ")[0]
    assert got.meta["traffic"] == dataclasses.asdict(
        campaign.TrafficConfig())
    assert campaign.TrafficConfig() == campaign.TrafficConfig(
        **dataclasses.asdict(jcampaign.TrafficConfig()))


def test_traffic_cli_runs_every_row(tmp_path):
    """The chaos CLI over the traffic workload: the five specs and the
    sweep, none skipped, nothing missed, no false alarm, and
    ``serve.paged_kv/pages`` protected (the ledger is empty)."""
    out = tmp_path / "traffic.json"
    assert cli.main(["--device", "cpu", "--space", "traffic-smoke",
                     "--workload", "traffic", "--json", str(out),
                     "--quiet"]) == 0
    d = json.loads(out.read_text())
    assert [(e["name"], e["outcome"], e["rung"]) for e in d["events"]] == \
        TRAFFIC_ROWS
    assert d["summary"]["missed_anywhere"] == []
    assert d["summary"]["false_alarms"] == []
    assert d["summary"]["by_outcome"].get("skipped", 0) == 0
    ledger = {s["surface"] for s in d["uncovered_surfaces"]}
    assert "serve.paged_kv/pages" not in ledger
    assert all(n.startswith("ft.runtime/") for n in ledger)
    assert faults.get_surface("serve.paged_kv/pages").protected

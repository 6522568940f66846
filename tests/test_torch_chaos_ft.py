"""The port's chaos campaign over the train and serve runtimes held against
the reference's one-device campaign: the SDC, DRAM and shard-loss drills
of the protected train step, `ElasticRuntime` and the protected serving
engine, their episodes and clean sweeps.

A live test runs both packages' `CampaignRunner` on one spec of each kind
and one episode of each workload; the whole-campaign test holds the port's
default space over ``("train", "serve")`` to the 67 rows of one run of
``PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.chaos --space
default --workload both`` on one CPU device (`REF_ROWS`).  Outcome, rung
and end state must be equal: the kind of agreement the campaign promises,
since the port draws its own random weights.
"""
import jax
import numpy as np
import pytest

import repro.chaos.campaign as jcampaign
import repro.chaos.faults as jfaults
import repro_torch.chaos.campaign as campaign
import repro_torch.chaos.faults as faults
from repro_torch.launch import chaos as cli

# name, outcome, rung, end state of every row of the reference's one-device
# campaign over the default space's train and serve workloads, in its order
REF_ROWS = [
    ("train:sdc_collective:s2", "corrected", "abft_inflight", "within_tol"),
    ("train:checksum_state_flip:s1", "detected", None, "bit_identical"),
    ("train:checksum_state_flip:s1:bf16:seed1", "detected", None,
     "bit_identical"),
    ("train:sdc_collective:s1:b20:int8", "corrected",
     "kernel:masked_recompute", "bit_identical"),
    ("train:flash_state_flip:s1", "corrected", "flash:recompute_tile",
     "within_tol"),
    ("train:norm_corruption:s2", "corrected", "recompute", "bit_identical"),
    ("train:gather_corruption:s2", "corrected", "recompute",
     "bit_identical"),
    ("train:dram_params:s2", "corrected", "scrub:diskless", "bit_identical"),
    ("train:dram_opt_state:s2:b29", "corrected", "scrub:diskless",
     "bit_identical"),
    ("train:shard_loss:s3", "corrected", "diskless", "bit_identical"),
    ("serve:sdc_collective:s1", "corrected", "abft_inflight",
     "bit_identical"),
    ("serve:dram_kv_cache:s2", "corrected", "scrub:kv_repair",
     "bit_identical"),
    ("train:sdc_collective:s4:d-30000:seed1", "corrected", "abft_inflight",
     "within_tol"),
    ("serve:sdc_collective:s3:sh1:d-30000:seed1", "skipped", None,
     "not_compared"),
    ("serve:dram_params:s0", "corrected", "scrub:restore", "bit_identical"),
    ("train:flash_state_flip:s2:l:seed1", "corrected", "flash:recompute_tile",
     "within_tol"),
    ("train:checksum_state_flip:s2:b29:int8:seed2", "detected", None,
     "bit_identical"),
    ("train:sdc_collective:s2:bf16:seed2", "corrected",
     "kernel:masked_recompute", "within_tol"),
    ("train:sdc_collective:s2:b28:seed3", "corrected",
     "kernel:masked_recompute", "within_tol"),
    ("train:shard_loss:s3:sh1:seed1", "skipped", None, "not_compared"),
    ("train:pod_loss:s3:diskless", "skipped", None, "not_compared"),
    ("train:pod_loss:s3:disk:seed1", "skipped", None, "not_compared"),
    ("train:slow_pod:s1", "skipped", None, "not_compared"),
    ("train:sdc+dram_burst::e0:sdc_collective", "corrected", "abft_inflight",
     "not_compared"),
    ("train:sdc+dram_burst::e1:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("train:sdc+dram_burst::e2:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("train:sdc+dram_burst::e3:dram_opt_state", "corrected",
     "scrub:diskless", "not_compared"),
    ("episode:train:sdc+dram_burst", "corrected",
     "abft_inflight+scrub:diskless", "within_tol"),
    ("serve:sdc+kv_dram::e0:sdc_collective", "corrected", "abft_inflight",
     "not_compared"),
    ("serve:sdc+kv_dram::e1:dram_kv_cache", "corrected", "scrub:kv_repair",
     "not_compared"),
    ("serve:sdc+kv_dram::e2:dram_params", "corrected", "scrub:restore",
     "not_compared"),
    ("episode:serve:sdc+kv_dram", "corrected",
     "abft_inflight+scrub:kv_repair+scrub:restore", "bit_identical"),
    ("train:poisson250::e0:shard_loss", "corrected", "diskless",
     "not_compared"),
    ("episode:train:poisson250", "corrected", "diskless", "bit_identical"),
    ("serve:poisson250::e0:dram_kv_cache", "corrected", "scrub:kv_repair",
     "not_compared"),
    ("serve:poisson250::e1:sdc_collective", "corrected", "abft_inflight",
     "not_compared"),
    ("episode:serve:poisson250", "corrected", "abft_inflight+scrub:kv_repair",
     "bit_identical"),
    ("episode:train:dram+podloss", "skipped", None, "not_compared"),
    ("episode:train:pod_repeat", "skipped", None, "not_compared"),
    ("train:poisson125::e0:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("episode:train:poisson125", "corrected", "scrub:diskless",
     "bit_identical"),
    ("train:poisson250::e0:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("train:poisson250::e1:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("train:poisson250::e2:shard_loss", "corrected", "diskless",
     "not_compared"),
    ("train:poisson250::e3:sdc_collective", "corrected", "abft_inflight",
     "not_compared"),
    ("train:poisson250::e4:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("train:poisson250::e5:dram_params", "corrected", "scrub:diskless",
     "not_compared"),
    ("episode:train:poisson250", "corrected",
     "abft_inflight+diskless+scrub:diskless", "within_tol"),
    ("train:poisson500::e0:sdc_collective", "corrected", "abft_inflight",
     "not_compared"),
    ("train:poisson500::e1:dram_opt_state", "corrected", "scrub:diskless",
     "not_compared"),
    ("train:poisson500::e2:shard_loss", "corrected", "diskless",
     "not_compared"),
    ("train:poisson500::e3:shard_loss", "corrected", "diskless",
     "not_compared"),
    ("train:poisson500::e4:sdc_collective", "corrected", "abft_inflight",
     "not_compared"),
    ("train:poisson500::e5:dram_opt_state", "corrected", "scrub:diskless",
     "not_compared"),
    ("episode:train:poisson500", "corrected",
     "abft_inflight+diskless+scrub:diskless", "within_tol"),
    ("serve:poisson125::e0:dram_params", "corrected", "scrub:restore",
     "not_compared"),
    ("episode:serve:poisson125", "corrected", "scrub:restore",
     "bit_identical"),
    ("serve:poisson250::e0:dram_params", "corrected", "scrub:restore",
     "not_compared"),
    ("serve:poisson250::e1:dram_params", "corrected", "scrub:restore",
     "not_compared"),
    ("episode:serve:poisson250", "corrected", "scrub:restore",
     "bit_identical"),
    ("train:clean_sweep:1x1:plain", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:plain:7st", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:protected", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:protected:9st", "clean", None, "bit_identical"),
    ("train:clean_sweep:1x1:scrub", "clean", None, "bit_identical"),
    ("serve:clean_sweep:1x1", "clean", None, "bit_identical"),
    ("serve:clean_sweep:1x1xscrub", "clean", None, "bit_identical"),
]
REF_BY_OUTCOME = {"corrected": 50, "absorbed": 0, "detected": 3,
                  "missed": 0, "false_alarm": 0, "clean": 7, "skipped": 7}
REF_EPISODES = {"corrected": 9, "skipped": 2}

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
    end state and detection."""
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")
    assert len(jax.devices()) == 1
    want = jcampaign.CampaignRunner(_space(jfaults)).run(("train", "serve"))
    got = campaign.CampaignRunner(_space(faults), device="cpu").run(
        ("train", "serve"))
    assert [_key(r) for r in got.results] == [_key(r) for r in want.results]
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
    one-device run."""
    out = tmp_path / "both.json"
    assert cli.main(["--device", "cpu", "--space", "default", "--workload",
                     "both", "--json", str(out), "--quiet"]) == 0
    import json
    d = json.loads(out.read_text())
    got = [(e["name"], e["outcome"], e["rung"], e["end_state"])
           for e in d["events"]]
    assert got == REF_ROWS
    assert d["summary"]["by_outcome"] == REF_BY_OUTCOME
    assert {k: v for k, v in d["episodes"]["by_outcome"].items() if v} == \
        REF_EPISODES
    assert d["summary"]["missed_anywhere"] == []
    assert d["summary"]["false_alarms"] == []
    for e in d["events"]:
        if e["outcome"] == "skipped":
            assert "slice 13" in e["note"], e["name"]
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

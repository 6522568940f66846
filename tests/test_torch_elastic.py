"""The port's protected train step, its SDC drills in `FTRuntime` and the
single-device `ElasticRuntime` (scrub, shard loss at p = 1) against the JAX
reference.

Smoke size (d 64, 2 layers, vocab 512) in fp32.  The reference's step is
built on a one-device mesh with ``Auto`` axes, as in
``tests/test_torch_train.py``; a state made by the reference is carried
over with ``convert.state_from_jax``.  Params after a protected step agree
to 1e-4 of each leaf's largest magnitude (fp32 sums in another order, and
Adam's first step divides by |g|).  A repaired gradient element carries the
rounding of the residual subtracted from it, a few ulps of |delta| in each
package, so the first moment, (1 - beta1) g, is held to 1e-4 of its leaf
plus (1 - beta1) 1e-6 |delta|.
"""
import jax
import numpy as np
import pytest
import torch

from repro.ft.failures import SDCInjector as JSDCInjector
from repro.ft.failures import SDCPlan as JSDCPlan
from repro.ft.runtime import FTPolicy as JPolicy
from repro.ft.runtime import FTRuntime as JFT
from repro.ft.runtime import stack_view as jstack
from repro.train.step import StepOptions as JOpts
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import state_from_jax
from repro_torch.ft.failures import (FailureInjector, FailurePlan,
                                     SDCInjector, SDCPlan, flip_bit)
from repro_torch.ft.runtime import (ElasticRuntime, FTPolicy, FTRuntime,
                                    ScrubReport, stack_view)
from repro_torch.kernels import checksum_encode as kenc
from repro_torch.train import optimizer as topt
from repro_torch.train.step import StepOptions, build_train_step
from repro_torch.tree import tree_leaves, tree_leaves_with_path
from test_torch_train import (ADAMW, ARCH, SHAPE, _batch, _jax_state,
                              _jax_step, _state_close)
from torch_port_helpers import to_np

PROTECTED = dict(remat=False, defer_grad_reduce=True, abft_reduce="correct")
B1 = topt.AdamWConfig().b1


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


@pytest.mark.parametrize("inject", [None, (0, 1e3),
                                    ((0, 1e3), (0, -3e4))])
def test_protected_step_matches_reference(inject):
    """Clean, one event, two events in two reductions: equal abft_ok, the
    loss and grad norm of the clean gradients, params within 1e-4."""
    jstate = _jax_state()
    kw = dict(PROTECTED, sdc_inject=inject)
    new_j, mj = _jax_step(JOpts(**kw))(jstate, _batch(0))
    step = build_train_step(tsmoke(ARCH), SHAPE, topt.AdamWConfig(**ADAMW),
                            StepOptions(**kw))
    new_t, mt = step(state_from_jax(jstate, tsmoke(ARCH)), _batch(0))
    assert float(mt["abft_ok"]) == float(mj["abft_ok"]) == \
        (1.0 if inject is None else 0.0)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-6)
    _state_close(stack_view(new_t["params"], 1), jstack(new_j["params"], 1),
                 rtol=1e-4)
    deltas = [] if inject is None else \
        [inject] if not isinstance(inject[0], tuple) else list(inject)
    delta = max((abs(d) for _, d in deltas), default=0.0)
    for (path, g), (_, w) in zip(
            tree_leaves_with_path(stack_view(new_t["opt"]["m"], 1)),
            jax.tree_util.tree_leaves_with_path(jstack(new_j["opt"]["m"],
                                                       1))):
        g, w = to_np(g).astype(np.float64), to_np(w).astype(np.float64)
        np.testing.assert_allclose(
            g, w, rtol=1e-4,
            atol=1e-4 * float(np.max(np.abs(w))) + (1 - B1) * 1e-6 * delta,
            err_msg=str(path))


def test_protected_step_repairs_to_the_clean_step():
    """The drilled step's params equal the clean protected step's (the
    repair sits in the gradient, and Adam's first update is its sign)."""
    state = state_from_jax(_jax_state(), tsmoke(ARCH))
    outs = []
    for inject in (None, (0, 1e3)):
        step = build_train_step(tsmoke(ARCH), SHAPE,
                                topt.AdamWConfig(**ADAMW),
                                StepOptions(**PROTECTED, sdc_inject=inject))
        outs.append(step(state, _batch(0)))
    (clean, mc), (drilled, md) = outs
    assert float(mc["abft_ok"]) == 1.0 and float(md["abft_ok"]) == 0.0
    for a, b in zip(tree_leaves(clean["params"]),
                    tree_leaves(drilled["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("opts,err", [
    (dict(abft_reduce="verify"), "requires defer_grad_reduce"),
    (dict(defer_grad_reduce=True, abft_reduce="correct", zero2=True),
     "incompatible with zero2"),
    (dict(sdc_inject=(0, 1.0)), "set abft_reduce"),
    (dict(defer_grad_reduce=True, invariant_checks=True),
     "invariant_checks rides"),
])
def test_step_option_checks_match_reference(opts, err):
    from repro.train.step import build_train_step as jbuild
    from test_torch_train import _mesh
    from repro.configs.base import smoke_config as jsmoke
    from repro.train import optimizer as jopt
    mesh = _mesh()
    with jax.set_mesh(mesh), pytest.raises(ValueError, match=err):
        jbuild(jsmoke(ARCH), mesh, SHAPE, jopt.AdamWConfig(), JOpts(**opts))
    with pytest.raises(ValueError, match=err):
        build_train_step(tsmoke(ARCH), SHAPE, opts=StepOptions(**opts))


# ---------------------------------------------------------------------------
# FTRuntime SDC drills
# ---------------------------------------------------------------------------


def test_runtime_step_drives_sdc_plans_as_the_reference():
    """The host-side drill protocol: which steps run the drilled variant,
    with which payload (one pair or a tuple), and the counts."""
    events = ((1, 0, 1e3), (3, 0, 2e3), (3, 0, -3e4), (9, 0, 1.0))
    runs = []
    for FT, Policy, Inj, Plan in ((JFT, JPolicy, JSDCInjector, JSDCPlan),
                                  (FTRuntime, FTPolicy, SDCInjector,
                                   SDCPlan)):
        rt = FT(1, Policy(), sdc_injector=Inj(Plan(events)))
        seen = []
        for i in range(5):
            out = rt.step(i, i, lambda s: ("clean", s),
                          run_step_sdc=lambda s, ev: ("sdc", s, ev))
            seen.append(out)
        # without a drill handler the events stay planned
        seen.append(rt.step(9, 9, lambda s: ("clean", s)))
        runs.append((seen, dict(rt.recoveries), len(rt.step_times)))
    assert runs[1] == runs[0]
    assert runs[1][0][1] == ("sdc", 1, (0, 1e3))
    assert runs[1][0][3] == ("sdc", 3, ((0, 2e3), (0, -3e4)))
    assert runs[1][1]["sdc"] == 2


# ---------------------------------------------------------------------------
# ElasticRuntime on one device
# ---------------------------------------------------------------------------


def _runtime(**kw):
    cfg = tsmoke(ARCH)
    return ElasticRuntime(
        cfg, ShapeConfig("e", 16, 8, "train"), kw.pop("mesh", (1, 1)),
        adamw=topt.AdamWConfig(lr=1e-3, total_steps=6, warmup_steps=1),
        opts=StepOptions(**PROTECTED), device="cpu",
        policy=kw.pop("policy", FTPolicy(diskless_every=1,
                                         disk_every=10 ** 6, scrub_every=1)),
        **kw)


def test_elastic_scrub_trips_on_a_flip_and_rolls_back_bit_for_bit():
    rt = _runtime()
    try:
        state = rt.init_state(0)
        for i in range(2):
            rt.checkpoint(i, state)
            state, rep = rt.scrub(i, state)
            assert rep is None                   # a clean scrub
            state, m = rt.train_step(i, state)
            assert float(m["abft_ok"]) == 1.0
        rt.checkpoint(2, state)
        plain = kenc.plain_calls
        grp = state["params"]["groups"][0]
        wq = grp[1]["b0"]["attn"]["wq"]
        bad = dict(state, params={**state["params"], "groups": [[
            grp[0], {"b0": {**grp[1]["b0"], "attn": {
                **grp[1]["b0"]["attn"],
                "wq": dict(wq, w=flip_bit(wq["w"], 7, bit=30))}}}]]})
        fixed, rep = rt.scrub(2, bad)
        # the verify re-encodes every floating leaf of the stacked state
        n_float = sum(1 for x in tree_leaves(stack_view(state, 1))
                      if x.is_floating_point())
        assert kenc.plain_calls - plain == n_float
        assert isinstance(rep, ScrubReport) and rep.rolled_back
        assert rep.leaf == \
            "['params']['groups'][0]['b0']['attn']['wq']['w']"
        assert rep.residual > 1e-6 and rt.recoveries["scrub"] == 1
        for a, b in zip(tree_leaves(fixed), tree_leaves(state)):
            assert torch.equal(a, b)
        # not an encode point: the scrub does not fire
        assert rt.scrub(3, bad) == (bad, None)
    finally:
        rt.close()


def test_elastic_scrub_reads_a_nan_residual_as_inf():
    rt = _runtime()
    try:
        state = rt.init_state(0)
        rt.checkpoint(0, state)
        w = state["params"]["embed"]["table"]
        nan = w.clone()
        nan[0, 0] = float("nan")
        bad = dict(state, params={**state["params"],
                                  "embed": {"table": nan}})
        _, rep = rt.scrub(0, bad)
        assert rep.residual == float("inf")
        assert rep.leaf == "['params']['embed']['table']"
    finally:
        rt.close()


def test_elastic_shard_loss_recovers_at_p1():
    """The single logical shard is lost and rebuilt from its checksum:
    the replay from the encode point ends where the clean run ends."""
    finals = []
    for plan in (None, FailurePlan(((3, 0),))):
        rt = _runtime(policy=FTPolicy(diskless_every=2, disk_every=10 ** 6),
                      injector=FailureInjector(plan) if plan else None)
        assert rt.p == 1
        try:
            state = rt.init_state(0)
            i, rollbacks = 0, []
            while i < 5:
                rt.checkpoint(i, state)
                state, rb = rt.maybe_shard_failure(i, state)
                if rb is not None:
                    rollbacks.append((i, rb))
                    i = rb
                    continue
                state, _ = rt.train_step(i, state)
                i += 1
            finals.append(state)
            assert rollbacks == ([] if plan is None else [(3, 2)])
            assert rt.recoveries["diskless"] == len(rollbacks)
        finally:
            rt.close()
    for a, b in zip(tree_leaves(finals[0]), tree_leaves(finals[1])):
        assert torch.equal(a, b)


def test_elastic_runtime_is_one_device():
    for mesh in ((2, 1), {"data": 1, "model": 2}):
        with pytest.raises(NotImplementedError, match="slice 13"):
            _runtime(mesh=mesh)
    rt = _runtime(mesh={"data": 1, "model": 1})
    try:
        state = rt.init_state(0)
        for call in (lambda: rt.lose_pod(state), lambda: rt.regrow(state),
                     lambda: rt.demote_pod(state, 0)):
            with pytest.raises(NotImplementedError, match="slice 13"):
                call()
        assert set(rt.recoveries) == {"diskless", "disk", "sdc", "elastic",
                                      "demote"}
        b = rt.place_batch(4)
        assert b["tokens"].shape == (8, 16) and b["tokens"].device.type == \
            "cpu"
    finally:
        rt.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ElasticRuntime(tsmoke(ARCH), ShapeConfig("e", 16, 8, "train"))


def test_policy_fields_match_reference():
    """FTPolicy carries the reference's fields, defaults and values; the
    straggler fields are set and read back as in the reference."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(FTPolicy)]
    assert sorted(names) == sorted(f.name for f in
                                   dataclasses.fields(JPolicy))
    assert dataclasses.asdict(FTPolicy()) == dataclasses.asdict(JPolicy())
    kw = dict(slow_pod_threshold=2.5, straggler_alpha=0.25,
              straggler_warmup=5, scrub_every=2)
    assert dataclasses.asdict(FTPolicy(**kw)) == \
        dataclasses.asdict(JPolicy(**kw))


def test_elastic_disk_fallback_restores_the_saved_state(tmp_path):
    """No diskless encode taken (the loop starts past the encode point):
    the shard loss falls back to the disk checkpoint of the last step."""
    from repro_torch.ckpt.disk import CheckpointManager
    rt = _runtime(policy=FTPolicy(diskless_every=10 ** 6, disk_every=1),
                  ckpt_manager=CheckpointManager(tmp_path),
                  injector=FailureInjector(FailurePlan(((2, 0),))))
    try:
        state = rt.init_state(0)
        saved = None
        for i in (1, 2):
            rt.checkpoint(i, state)
            state, rb = rt.maybe_shard_failure(i, state)
            if rb is not None:
                assert (i, rb) == (2, 2) and rt.recoveries["disk"] == 1
                break
            state, _ = rt.train_step(i, state)
            saved = state
        for a, b in zip(tree_leaves(state), tree_leaves(saved)):
            assert torch.equal(a, b)
        assert rt.ckpt.aux(2)["data_step"] == 2
    finally:
        rt.close()

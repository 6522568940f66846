"""The port's pod paths against the JAX reference: the reshard plan, the
train step at DP extent 2 and 4 on stacked shards, the pod-loss drill and
the straggler detector.

Smoke Qwen2-0.5B (d 64, 2 layers, vocab 512) in fp32.  The reference's
multi-device paths do not run on this one-device CPU (its drill stops at
the embedding gather under this jax), so the port is held to:

  * the reference's spec functions on a ``jax.sharding.AbstractMesh`` for
    the placement diff: the same summary and report, exactly;
  * the reference's 1 x 1 step (an ``Auto``-axis mesh) on the same
    converted state and batch for the step at DP extent 2 and 4: the loss
    to 1e-6 relative and params to 1e-4 of each leaf's largest magnitude
    (the shards' fp32 gradients are summed in another order, and Adam's
    first step divides by |g|);
  * the reference's own drill assertions (``tests/test_elastic.py``) for
    the drill, with one departure: the port's step is eager, so the
    shrink compiles nothing (``compile_s == 0.0``) and a re-grow reports
    ``reused_executable`` where the reference asserts ``compile_s > 0``;
  * the reference's `StragglerDetector` on the same wall sequences.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.ckpt.elastic import plan_reshard as jplan
from repro.ckpt.elastic import survivor_mesh as jsurvivor
from repro.configs.base import smoke_config as jsmoke_config
from repro.ft.runtime import StragglerDetector as JStraggler
from repro.ft.runtime import stack_view as jstack
from repro.train.step import StepOptions as JOpts
from repro.train.step import init_state as jinit
from repro_torch.ckpt.elastic import (plan_reshard, reshard_state,
                                      survivor_mesh)
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import state_from_jax
from repro_torch.dist.sharding import Mesh
from repro_torch.ft.runtime import StragglerDetector, stack_view
from repro_torch.launch.train import run_elastic_drill
from repro_torch.train import optimizer as topt
from repro_torch.train.step import StepOptions, build_train_step, state_shapes
from repro_torch.tree import tree_leaves
from test_torch_train import (ADAMW, ARCH, SHAPE, _batch, _jax_state,
                              _jax_step, _state_close)
from torch_port_helpers import to_np

POD = ("pod", "data", "model")


def jsmoke():
    return jsmoke_config(ARCH)


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def test_reshard_plan_matches_reference():
    """(2, 2, 2) -> (2, 2) on the smoke Qwen2-0.5B state: 44 leaves, 28
    re-specced, 1,284,872 bytes of which 856,576 change spec, the same
    summary and report as the reference's plan on abstract meshes; and the
    reverse plan of the re-grow."""
    jstate = jax.eval_shape(lambda k: jinit(k, jsmoke(), JOpts()),
                            jax.random.PRNGKey(0))
    tstate = state_shapes(tsmoke(ARCH))
    for old, new in [((2, 2, 2), (2, 2)), ((2, 2), (2, 2, 2)),
                     ((2, 1, 1), (1, 1)), ((2, 16, 16), (16, 16))]:
        names = lambda s: POD if len(s) == 3 else ("data", "model")
        plan = plan_reshard(tstate, Mesh(old, names(old), "cpu"),
                            Mesh(new, names(new), "cpu"), StepOptions(),
                            tsmoke(ARCH))
        want = jplan(jstate, AbstractMesh(old, names(old)),
                     AbstractMesh(new, names(new)), JOpts(), jsmoke())
        assert plan.summary() == want.summary()
        assert plan.report(top=100) == want.report(top=100)
        assert [dataclasses.astuple(l) for l in plan.leaves] == \
            [dataclasses.astuple(l) for l in want.leaves]
    shrink = plan_reshard(tstate, Mesh((2, 2, 2), POD, "cpu"),
                          Mesh((2, 2), ("data", "model"), "cpu"))
    assert (len(shrink.leaves), shrink.n_respecced, shrink.bytes_total,
            shrink.bytes_respecced) == (44, 28, 1_284_872, 856_576)


def test_survivor_mesh_matches_reference():
    """The survivor keeps the non-pod axes and shrinks the pod extent; one
    pod left drops the axis.  The reference builds a real mesh, so it is
    called where one device holds the survivor."""
    got = survivor_mesh(mesh=Mesh((2, 1, 1), POD, "cpu"))
    ref = jsurvivor(failed_pods=1, mesh=_ref_pod_mesh())
    assert dict(got.shape) == dict(ref.shape) and \
        got.axis_names == ref.axis_names and got.device.type == "cpu"
    three = survivor_mesh(mesh=Mesh((3, 2, 2), POD, "cpu"))
    assert dict(three.shape) == {"pod": 2, "data": 2, "model": 2}
    assert dict(survivor_mesh(2, mesh=Mesh((3, 2, 2), POD, "cpu")).shape) \
        == {"data": 2, "model": 2}
    assert dict(survivor_mesh(device="cpu").shape) == {"data": 16,
                                                       "model": 16}
    with pytest.raises(ValueError, match="no survivors"):
        survivor_mesh(2, mesh=Mesh((2, 1, 1), POD, "cpu"))
    with pytest.raises(ValueError, match="no 'pod' axis"):
        survivor_mesh(mesh=Mesh((2, 2), ("data", "model"), "cpu"))


def _ref_pod_mesh():
    """A (pod 2, data 1, model 1) stand-in the reference's survivor_mesh
    reads (shape and axis names only); its survivor is one device."""
    class _M:
        shape = {"pod": 2, "data": 1, "model": 1}
        axis_names = POD
    return _M()


@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("deferred", [False, True])
def test_step_at_dp_extent_matches_reference(mesh, deferred):
    """The step at DP extent 2 and 4 (each shard's gradients on its local
    batch, reduced over the stacked axis: a plain mean, or the verified
    reduction on the deferred path) against the reference's 1 x 1 step on
    the same state and batch."""
    names = POD if len(mesh) == 3 else ("data", "model")
    kw = dict(remat=False)
    if deferred:
        kw.update(defer_grad_reduce=True, abft_reduce="correct")
    jstate = _jax_state()
    new_j, mj = _jax_step(JOpts(**kw))(jstate, _batch(0))
    step = build_train_step(tsmoke(ARCH), SHAPE, topt.AdamWConfig(**ADAMW),
                            StepOptions(**kw),
                            mesh=Mesh(mesh, names, "cpu"))
    assert step.split == int(np.prod(mesh[:-1]))
    new_t, mt = step(state_from_jax(jstate, tsmoke(ARCH)), _batch(0))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    if deferred:
        assert float(mt["abft_ok"]) == float(mj["abft_ok"]) == 1.0
    _state_close(stack_view(new_t["params"], 1), jstack(new_j["params"], 1),
                 rtol=1e-4)


def test_step_at_dp_extent_one_is_the_one_device_step():
    """A 1 x 1 mesh gives today's step bit for bit, plain and protected."""
    cfg = tsmoke(ARCH)
    state = state_from_jax(_jax_state(), cfg)
    for kw in (dict(remat=False), dict(remat=False, defer_grad_reduce=True,
                                       abft_reduce="correct")):
        a = build_train_step(cfg, SHAPE, topt.AdamWConfig(**ADAMW),
                             StepOptions(**kw))(state, _batch(0))[0]
        b = build_train_step(cfg, SHAPE, topt.AdamWConfig(**ADAMW),
                             StepOptions(**kw),
                             mesh=Mesh((1, 1), ("data", "model"), "cpu"))(
            state, _batch(0))[0]
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))


@pytest.mark.parametrize("shard", [0, 3])
def test_sdc_on_one_of_four_shards_is_corrected(shard):
    """An SDC on shard j of 4 hits that shard's contribution to the
    verified reduction: flagged (abft_ok 0) and repaired, the params
    within 1e-4 of each leaf's magnitude of the clean step's."""
    cfg = tsmoke(ARCH)
    mesh = Mesh((2, 2, 2), POD, "cpu")
    kw = dict(remat=False, defer_grad_reduce=True, abft_reduce="correct")
    state = state_from_jax(_jax_state(), cfg)
    clean, mc = build_train_step(cfg, SHAPE, topt.AdamWConfig(**ADAMW),
                                 StepOptions(**kw), mesh=mesh)(
        state, _batch(0))
    hit, mh = build_train_step(cfg, SHAPE, topt.AdamWConfig(**ADAMW),
                               StepOptions(**kw, sdc_inject=(shard, 1e4)),
                               mesh=mesh)(state, _batch(0))
    assert float(mc["abft_ok"]) == 1.0 and float(mh["abft_ok"]) == 0.0
    for a, b in zip(tree_leaves(hit["params"]), tree_leaves(clean["params"])):
        a, b = to_np(a), to_np(b)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_pod_loss_drill_meets_the_reference_assertions():
    """`python -m repro_torch.launch.train --device cpu --drill-mesh 2x2x2
    --kill-pod-at-step 3 --regrow-at-step 8 --steps 10 --batch 8 --seq 32`:
    every assertion of tests/test_elastic.py's drill, compile_s > 0 on the
    shrink replaced by the eager step's build record."""
    rep = run_elastic_drill("qwen2-0.5b", steps=10, kill_pod_at=3,
                            regrow_at=8, batch=8, seq=32,
                            mesh_shape=(2, 2, 2), verbose=False,
                            device="cpu")
    parity = rep["parity"]
    assert parity["params_bitwise_equal"] is True
    assert parity["steps_compared"] >= 5
    assert parity["max_abs_loss_diff"] == 0.0
    assert parity["loss_parity"] is True
    assert rep["shrink"]["restore_path"] == "disk"
    assert (rep["shrink"]["n_leaves"], rep["shrink"]["n_respecced"],
            rep["shrink"]["bytes_total"],
            rep["shrink"]["bytes_respecced"]) == (44, 28, 1_284_872,
                                                 856_576)
    # the departure: nothing compiles; the survivor's step is new (built),
    # the re-grow's is generation 0's, fetched from the cache
    assert rep["shrink"]["compile_s"] == 0.0
    assert rep["shrink"]["reused_executable"] is False
    assert rep["regrow"]["reused_executable"] is True
    assert rep["regrow"]["compile_s"] == 0.0
    assert rep["regrow"]["rollback_step"] is None
    assert rep["recoveries"]["elastic"] == 2
    assert all(np.isfinite(v) for v in rep["losses"].values())
    assert rep["survivor_mesh"] == {"data": 2, "model": 2}


def test_pod_loss_drill_diskless_rung_3a():
    """A pod loss that fits the checksum capacity shrinks without disk:
    the diskless state is solved and re-keyed (re-encoded) at the survivor
    extent; near-exact, with the reference's thresholds."""
    rep = run_elastic_drill("qwen2-0.5b", steps=5, kill_pod_at=2,
                            regrow_at=None, batch=4, seq=32,
                            mesh_shape=(2, 1, 1), verbose=False,
                            device="cpu")
    assert rep["shrink"]["restore_path"] == "diskless"
    parity = rep["parity"]
    assert parity["steps_compared"] >= 3
    assert parity["params_max_abs_diff"] < 1e-4
    assert parity["max_abs_loss_diff"] < 1e-3
    assert rep["recoveries"]["elastic"] == 1


def test_reshard_state_copies_through_the_host():
    """The live re-placement returns new tensors on the new mesh's device,
    equal bit for bit."""
    state = {"a": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(3)}
    out = reshard_state({"params": state}, Mesh((2, 2), ("data", "model"),
                                                "cpu"))
    assert torch.equal(out["params"]["a"], state["a"])
    assert out["params"]["a"].data_ptr() != state["a"].data_ptr()


def _walls(rs, n_pods, steps, slow, factor):
    out = []
    for _ in range(steps):
        w = list(0.1 + 0.01 * rs.rand(n_pods))
        if slow is not None:
            w[slow] *= factor
        out.append(w)
    return out


@pytest.mark.parametrize("n_pods,slow,factor,threshold,warmup,alpha", [
    (2, 1, 4.0, 3.0, 3, 0.5), (2, 0, 2.5, 3.0, 3, 0.5),
    (4, 2, 3.5, 3.0, 2, 0.3), (3, None, 1.0, 2.0, 1, 0.5),
    (1, 0, 9.0, 2.0, 1, 0.5), (4, 3, 2.2, 2.0, 4, 0.9)])
def test_straggler_detector_trips_as_reference(n_pods, slow, factor,
                                               threshold, warmup, alpha):
    """The same wall sequences (a pod slowed part way through) trip both
    detectors on the same steps, naming the same pod, with the same
    EWMAs."""
    rs = np.random.RandomState(n_pods * 7 + warmup)
    seq = _walls(rs, n_pods, 4, None, 1.0) + _walls(rs, n_pods, 8, slow,
                                                    factor)
    mine = StragglerDetector(n_pods, threshold, alpha=alpha, warmup=warmup)
    ref = JStraggler(n_pods, threshold, alpha=alpha, warmup=warmup)
    trips = [(mine.observe(w), ref.observe(w)) for w in seq]
    assert [a for a, _ in trips] == [b for _, b in trips]
    assert mine.ewma == ref.ewma
    if slow is not None and n_pods > 1 and factor > threshold:
        assert trips[-1][0] == slow
    with pytest.raises(ValueError, match="pod walls"):
        mine.observe([0.1] * (n_pods + 1))


def test_moe_groups_follow_the_dp_shards():
    """The standard path cuts the global batch into DP-extent contiguous
    dispatch groups, as the reference's device-local sort does
    (``moe_groups`` set from the mesh): at DP extent 2 the step's loss is
    the model's loss over the global batch in two groups, to fp32
    rounding, and not the one-group loss of the 1 x 1 step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import transformer as ttf
    from repro_torch.train.step import init_state
    cfg = tsmoke("qwen3-moe-30b-a3b")
    shape = ShapeConfig("t", 16, 4, "train")
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (4, 16)),
             "labels": rs.randint(0, cfg.vocab_size, (4, 16))}
    state = init_state(torch.Generator().manual_seed(0), cfg)
    opts = StepOptions(remat=False)
    _, m_dp = build_train_step(cfg, shape, opts=opts,
                               mesh=Mesh((2, 1), ("data", "model"), "cpu"))(
        state, batch)
    _, m_one = build_train_step(cfg, shape, opts=opts)(state, batch)
    tok, lab = (torch.from_numpy(batch[k]) for k in ("tokens", "labels"))
    with torch.no_grad():
        want = {g: float(ttf.loss_fn(state["params"], tok, lab,
                                     cfg.scaled(moe_groups=g),
                                     aux_weight=opts.aux_weight))
                for g in (1, 2)}
    np.testing.assert_allclose(float(m_dp["loss"]), want[2], rtol=1e-6)
    np.testing.assert_allclose(float(m_one["loss"]), want[1], rtol=1e-6)
    assert abs(want[2] - want[1]) > 1e-4

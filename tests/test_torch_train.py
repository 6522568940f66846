"""The port's training path against the JAX reference: optimizer, data,
autograd through kernel #1's path and the chunked attention, the loss, the
stacked DP view, one train step, an FT loop with a diskless recovery, and
the training CLI with its disk resume.

Everything runs at the smoke size (d 64, 2 layers, vocab 512) in fp32,
where the point is the algorithm.  A state made by the reference is carried
over with ``convert.state_from_jax``, and both packages see the same numpy
batches.  The reference's train step is built on a one-device mesh with
``Auto`` axes (on this jax its default ``Explicit`` axes reject the step's
sharding constraints on one device).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.base import smoke_config as jsmoke
from repro.data import pipeline as jdata
from repro.ft.failures import FailureInjector as JInjector
from repro.ft.failures import FailurePlan as JPlan
from repro.ft.runtime import FTPolicy as JPolicy
from repro.ft.runtime import FTRuntime as JFT
from repro.ft.runtime import stack_view as jstack
from repro.ft.runtime import unstack_view as junstack
from repro.kernels import ops as jops
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train.step import StepOptions as JOpts
from repro.train.step import build_train_step as jbuild
from repro.train.step import init_state as jinit
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data import pipeline as tdata
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.ft.runtime import FTPolicy, FTRuntime, stack_view, \
    unstack_view
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import checksum_encode as kenc
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train.step import StepOptions, build_train_step, \
    init_state
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_unflatten
from torch_port_helpers import (assert_close, one_torch_thread,  # noqa: F401
                                to_np)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "qwen2-0.5b"
SHAPE = ShapeConfig("t", 32, 8, "train")
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _jax_step(opts, adamw=ADAMW):
    """The reference's jitted train step on a one-device mesh."""
    mesh = _mesh()
    with jax.set_mesh(mesh):
        fn, in_sh, out_sh = jbuild(jsmoke(ARCH), mesh, SHAPE,
                                   jopt.AdamWConfig(**adamw), opts)
        jfn = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)

    def step(state, batch):
        with jax.set_mesh(mesh):
            b = {k: jnp.asarray(v) for k, v in batch.items()}
            return jfn(jax.device_put(state, in_sh[0]),
                       jax.device_put(b, in_sh[1]))
    return step


def _jax_state(seed=0):
    cfg = jsmoke(ARCH)
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), cfg,
                                          JOpts()))


def _batch(step, seed=0):
    return jdata.synthetic_batch(
        jdata.DataConfig(jsmoke(ARCH).vocab_size, SHAPE.seq_len,
                         SHAPE.global_batch, seed=seed), step)


def _state_close(got, want, rtol):
    """Leaf for leaf in flattening order (the port's dict order is the
    reference's), each within rtol of the leaf's largest magnitude."""
    gl = tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert len(gl) == len(wl)
    for (gp, g), (wp, w) in zip(gl, wl):
        assert jax.tree_util.keystr(wp) == "".join(f"[{k!r}]" for k in gp)
        g, w = to_np(g).astype(np.float64), to_np(w).astype(np.float64)
        assert g.shape == w.shape, (gp, g.shape, w.shape)
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale,
                                   err_msg=str(gp))


# ---------------------------------------------------------------------------
# optimizer and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=3, total_steps=9),
                                 dict(warmup_steps=0, total_steps=1)])
def test_schedule_matches_reference(cfg):
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for s in [0, 1, 2, 3, 5, 9, 50, 99, 100, 101, 5000, 9999, 10000, 20000]:
        got = topt._schedule(tc, torch.tensor(s, dtype=torch.int32))
        want = jopt._schedule(jc, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_update_matches_reference(rs):
    """bf16 params, fp32 moments, three updates: the update in fp32,
    rounded once to bf16 (a bf16 value may round one ulp apart where the
    fp32 updates differ in their last bits)."""
    params = {"a": rs.standard_normal((7, 5)).astype(np.float32),
              "b": {"c": rs.standard_normal(3).astype(np.float32),
                    "d": rs.standard_normal((2, 4, 6)).astype(np.float32)}}
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    tp = tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), params)
    jo, to = jopt.adamw_init(jp), topt.adamw_init(tp)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    for it in range(3):
        g = jax.tree.map(lambda x: rs.standard_normal(x.shape)
                         .astype(np.float32), params)
        jp, jo, jm = jopt.adamw_update(
            jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g), jo, jp,
            jopt.AdamWConfig(**cfg))
        tp, to, tm = topt.adamw_update(
            tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), g),
            to, tp, topt.AdamWConfig(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(to["count"]) == int(jo["count"]) == it + 1
        for a, b in zip(tree_leaves(to["m"]) + tree_leaves(to["v"]),
                        jax.tree.leaves(jo["m"]) + jax.tree.leaves(jo["v"])):
            assert a.dtype == torch.float32
            assert_close(a, b, rtol=1e-5)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(to_np(a), to_np(b), rtol=2 ** -7,
                                       atol=1e-6)


def test_global_norm_matches_reference(rs):
    tree = {"x": rs.standard_normal((5, 3)).astype(np.float32),
            "y": [rs.standard_normal(4).astype(np.float32)]}
    got = topt.global_norm(tree_map(torch.from_numpy, tree))
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 123), (11, 99999)])
def test_synthetic_batch_bit_identical(seed, step):
    cfg = dict(vocab_size=151936, seq_len=64, global_batch=4, seed=seed)
    got = tdata.synthetic_batch(tdata.DataConfig(**cfg), step)
    want = jdata.synthetic_batch(jdata.DataConfig(**cfg), step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_prefetch_resume_and_resplit():
    cfg = tdata.DataConfig(512, 16, 4, seed=5)
    pipe = tdata.DataPipeline(cfg, start_step=3)
    try:
        for s in (3, 4, 5):
            np.testing.assert_array_equal(next(pipe)["tokens"],
                                          tdata.synthetic_batch(cfg, s)
                                          ["tokens"])
        state = pipe.state_dict()
        assert state["step"] == 6
    finally:
        pipe.close()
    with pytest.raises(ValueError):
        tdata.DataPipeline.resume(dataclasses.replace(cfg, seq_len=8), state)
    again = tdata.DataPipeline.resume(cfg, state)
    try:
        np.testing.assert_array_equal(next(again)["tokens"],
                                      tdata.synthetic_batch(cfg, 6)["tokens"])
        split = again.resplit(2)
        assert split.local_batch == 2
        split.close()
    finally:
        again.close()


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["default", "residual"])
def test_kernel_path_gradient_matches_reference(rs, weights):
    """The autograd Function around the one-shot path (its plain version on
    a CPU tensor) against jax.grad of the reference's ops.abft_matmul
    through its Pallas kernel in interpret mode, with cotangents on the
    output and on both checksum directions (tests/test_kernels.py's
    pattern); the encoding weights get zero gradients."""
    m, k, n = 96, 128, 80
    a = rs.standard_normal((m, k)).astype(np.float32)
    b = rs.standard_normal((k, n)).astype(np.float32)
    wm = ops.kernel_weights(m).numpy()
    if weights == "default":
        wn = ops.kernel_weights(n).T.numpy()
    else:   # [w_r; -I]: the row direction is the verification residual
        wn = np.concatenate([rs.standard_normal((n - 2, 2)), -np.eye(2)]) \
            .astype(np.float32)
        b = b[:, :n]

    def jloss(x, y):
        c, col, row = jops.abft_matmul(x, y, wm=jnp.asarray(wm),
                                       wn=jnp.asarray(wn), force_pallas=True)
        return jnp.sum(c ** 2) + jnp.sum(col) + jnp.sum(row ** 2)

    ga_j, gb_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                 jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    wmt = torch.from_numpy(wm).requires_grad_(True)
    wnt = torch.from_numpy(wn).requires_grad_(True)
    plain = kmm.plain_calls
    c, col, row = ops.abft_matmul(at, bt, wm=wmt, wn=wnt)
    (torch.sum(c ** 2) + torch.sum(col) + torch.sum(row ** 2)).backward()
    assert kmm.plain_calls == plain + 1
    for got, want in ((at.grad, ga_j), (bt.grad, gb_j)):
        scale = float(jnp.max(jnp.abs(want)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5 * scale)
    assert not wmt.grad.any() and not wnt.grad.any()


@pytest.mark.parametrize("window,softcap", [(None, None), (24, None),
                                            (None, 5.0)])
def test_chunked_attention_gradient_matches_reference(rs, window, softcap):
    """Autograd through the port's chunked online-softmax forward computes
    the gradient of the reference's custom-VJP FA-2 backward (sk a multiple
    of kc, where the reference's chunking is right)."""
    b, s, g_kv, g, d, kc = 1, 48, 2, 2, 8, 16
    q = rs.standard_normal((b, s, g_kv, g, d)).astype(np.float32)
    k = rs.standard_normal((b, s, g_kv, d)).astype(np.float32)
    v = rs.standard_normal((b, s, g_kv, d)).astype(np.float32)
    w = rs.standard_normal((b, s, g_kv, g, d)).astype(np.float32)
    pos = np.arange(s)
    kw = dict(scale=d ** -0.5, softcap=softcap, causal=True, window=window)

    def jloss(q_, k_, v_):
        o = jattn._sdpa_flash(q_, k_, v_, q_pos=jnp.asarray(pos),
                              k_pos=jnp.asarray(pos), kc=kc, **kw)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o, _ = tattn._flash_fwd_impl(qt, kt, vt, torch.from_numpy(pos),
                                 torch.from_numpy(pos), kc=kc, **kw)
    torch.sum(o * torch.from_numpy(w)).backward()
    for got, exp in zip((qt.grad, kt.grad, vt.grad), want):
        assert_close(got, exp, rtol=1e-4)


def test_loss_and_remat_match_reference():
    """loss_fn on carried params; per-block checkpointing recomputes the
    blocks in the backward and gives the same gradients."""
    jstate = _jax_state()
    cfg = tsmoke(ARCH)
    params = params_from_jax(jstate["params"], cfg)
    batch = _batch(0)
    toks, labs = (torch.from_numpy(batch[k]).long()
                  for k in ("tokens", "labels"))
    want = jtf.loss_fn(jax.tree.map(jnp.asarray, jstate["params"]),
                       jnp.asarray(batch["tokens"]),
                       jnp.asarray(batch["labels"]), jsmoke(ARCH))
    grads = {}
    for remat in (False, True):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = ttf.loss_fn(tree_unflatten(params, live), toks, labs, cfg,
                           remat=remat)
        np.testing.assert_allclose(float(loss.detach()), float(want),
                                   rtol=1e-6)
        grads[remat] = torch.autograd.grad(loss, live)
    for a, b in zip(grads[False], grads[True]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the stacked DP view, one step, the FT loop
# ---------------------------------------------------------------------------


def test_stack_view_matches_reference():
    """Stacking the per-layer lists, then splitting the leading axis by p,
    gives the reference's stacked leaves: the same values in the same flat
    order; logical shard i of a group holds its layers i R/p .. """
    jstate = _jax_state()
    cfg = tsmoke(ARCH)
    state = state_from_jax(jstate, cfg)
    for p in (2, 4):
        got = stack_view(state, p)
        want = jstack(jax.tree.map(jnp.asarray, jstate), p)
        gl, wl = tree_leaves_with_path(got), \
            jax.tree_util.tree_leaves_with_path(want)
        assert len(gl) == len(wl)
        for (gp, g), (wp, w) in zip(gl, wl):
            assert jax.tree_util.keystr(wp) == "".join(f"[{k!r}]"
                                                      for k in gp)
            np.testing.assert_array_equal(to_np(g), to_np(w))
        # every tensor of the view is new: the checkpoint may own it
        live = {t.data_ptr() for t in tree_leaves(state)}
        assert not live & {t.data_ptr() for t in tree_leaves(got)}
        back = unstack_view(got, state)
        for a, b in zip(tree_leaves(back), tree_leaves(state)):
            assert a.shape == b.shape and torch.equal(a, b)
    # bf16 leaves too (the full-width dtype)
    bf = tree_map(lambda x: x.to(torch.bfloat16)
                  if x.is_floating_point() else x, state)
    sv = stack_view(bf, 2)
    assert sv["params"]["groups"][0]["b0"]["mlp"]["up"]["w"].dtype \
        == torch.bfloat16


def test_state_from_jax_carries_the_whole_state():
    jstate = _jax_state()
    state = state_from_jax(jstate, tsmoke(ARCH))
    assert sorted(state) == ["opt", "params", "step"]
    assert sorted(state["opt"]) == ["count", "m", "v"]
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert len(state["params"]["groups"][0]) == 2       # per-layer list
    jl = jax.tree.leaves(jstate)
    tl = tree_leaves(stack_view(state, 1))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(to_np(a).reshape(np.shape(b)),
                                      np.asarray(b))


@pytest.mark.parametrize("abft", ["off", "verify"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_matches_reference(abft, microbatches):
    """Loss, grad norm, lr and every leaf of the new state (params, both
    moments, the counters) from one state carried across.  fp32 sums in
    another order; Adam's first step divides by |g|, so leaves agree to
    1e-4 of their largest magnitude (measured 4e-5)."""
    jo = JOpts(microbatches=microbatches, abft_mode=abft, remat=False)
    to = StepOptions(microbatches=microbatches, abft_mode=abft, remat=False)
    jstate = _jax_state()
    new_j, mj = _jax_step(jo)(jstate, _batch(0))
    step = build_train_step(tsmoke(ARCH), SHAPE, topt.AdamWConfig(**ADAMW),
                            to)
    new_t, mt = step(state_from_jax(jstate, tsmoke(ARCH)), _batch(0))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
    _state_close(stack_view(new_t, 1), jstack(new_j, 1), rtol=1e-4)


def test_protected_projections_train_through_the_kernel_path():
    """abft verify with the kernel backend (its plain version here): the
    step runs every protected projection through kernel #1's path, 7 per
    block, twice per block with remat (the backward recomputes it), and
    matches the plain-matmul backend."""
    state = state_from_jax(_jax_state(), tsmoke(ARCH))
    out = {}
    for backend in ("ref", "cuda"):
        step = build_train_step(
            tsmoke(ARCH), SHAPE, topt.AdamWConfig(**ADAMW),
            StepOptions(abft_mode="verify", abft_backend=backend,
                        remat=True))
        plain = kmm.plain_calls
        out[backend] = step(state, _batch(0))
        calls = kmm.plain_calls - plain
        assert calls == (7 * 2 * 2 if backend == "cuda" else 0)
    (sr, mr), (sc, mc) = out["ref"], out["cuda"]
    np.testing.assert_allclose(float(mc["loss"]), float(mr["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mc["grad_norm"]),
                               float(mr["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree_leaves(sc), tree_leaves(sr)):
        assert_close(a, b, rtol=1e-4)


def _ft_loop(pkg, state, step_fn, plan, steps=12, every=3, p=4):
    """launch/train.py's loop around a given state and step."""
    stack, unstack, Runtime, Policy, Injector, Plan = pkg
    ft = Runtime(p, Policy(diskless_every=every, disk_every=1000),
                 injector=Injector(Plan(plan)))
    losses, ran, rollbacks = [], [], []
    i = 0
    while i < steps:
        ft.maybe_checkpoint(i, stack(state, p))
        failed = ft.injector.check(i)
        if failed is not None:
            stacked = Injector.damage(stack(state, p), failed, p)
            state = unstack(ft.recover(stacked, [failed]), state)
            rollbacks.append((i, failed, ft.diskless.step))
            i = ft.diskless.step
        state, m = step_fn(state, _batch(i))
        losses.append(float(m["loss"]))
        ran.append(i)
        i += 1
    return losses, ran, rollbacks, ft.recoveries


@pytest.mark.parametrize("p", [2, 4])
def test_ft_loop_with_a_diskless_recovery_matches_reference(p):
    """Twelve steps, an encode every 3, a shard lost at step 5: both roll
    back to step 3 and replay; the losses agree (fp32 drift over 14 steps),
    and each replayed step repeats its first pass (a near-exact fp32
    solve).  With p = 2 the smoke config's two layers are split over the
    shards, so the lost shard holds a layer of every group leaf; with p = 4
    only the embedding and the final norm are split."""
    plan = FailurePlan.random(1, 12, p, seed=0).events
    assert plan == JPlan.random(1, 12, p, seed=0).events
    (fail_step, shard), = plan
    assert fail_step == 5
    opts = dict(microbatches=1, abft_mode="off", remat=False)
    jstate = _jax_state()
    jl, jran, jrb, jrec = _ft_loop(
        (jstack, junstack, JFT, JPolicy, JInjector, JPlan),
        jax.tree.map(jnp.asarray, jstate), _jax_step(JOpts(**opts)), plan,
        p=p)
    step = build_train_step(tsmoke(ARCH), SHAPE, topt.AdamWConfig(**ADAMW),
                            StepOptions(**opts))
    tl, tran, trb, trec = _ft_loop(
        (stack_view, unstack_view, FTRuntime, FTPolicy, FailureInjector,
         FailurePlan), state_from_jax(jstate, tsmoke(ARCH)), step, plan,
        p=p)
    assert tran == jran == [0, 1, 2, 3, 4, 3, 4] + list(range(5, 12))
    assert trb == jrb == [(5, shard, 3)]
    assert trec == jrec == {"diskless": 1, "disk": 0, "sdc": 0}
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tl[5:7], tl[3:5], rtol=1e-6)


def test_run_resumes_from_its_disk_checkpoint(tmp_path, capsys):
    """Eight steps straight, against four steps, a final save, and a
    resume for the other four: the same losses, bit for bit."""
    kw = dict(batch=4, seq=16, total_steps=8, device="cpu", log_every=1)
    full = ttrain.run(ARCH, steps=8, **kw)
    ttrain.run(ARCH, steps=4, ckpt_dir=str(tmp_path), **kw)
    resumed = ttrain.run(ARCH, steps=8, ckpt_dir=str(tmp_path), resume=True,
                         **kw)
    assert resumed.resumed_from == 4 and resumed.steps == [4, 5, 6, 7]
    assert resumed.losses == full.losses[4:]
    assert "[train] resumed from step 4" in capsys.readouterr().out
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(full.state)):
        assert torch.equal(a, b)


def test_run_prints_the_reference_lines(capsys):
    """The CLI's loop: the same failure plan, rollback and recoveries as
    the reference's run(), and its log lines."""
    r = ttrain.run(ARCH, steps=12, batch=8, seq=32, inject_failures=1,
                   diskless_every=3, device="cpu", log_every=1)
    out = capsys.readouterr().out
    jtrain.run(ARCH, steps=12, batch=8, seq=32, inject_failures=1,
               diskless_every=3, mesh=_mesh(), log_every=1)
    jout = capsys.readouterr().out

    def lines(text, key):
        return [ln for ln in text.splitlines() if key in ln]
    assert lines(out, "lost;") == lines(jout, "lost;") == [
        "[train] step 5: shard 3 lost; diskless recovery -> rollback to "
        "step 3"]
    assert lines(out, "recoveries=")[0].split("recoveries=")[1] \
        == lines(jout, "recoveries=")[0].split("recoveries=")[1]
    assert len(lines(out, "loss=")) == len(lines(jout, "loss=")) == 14
    assert r.ft.recoveries["diskless"] == 1 and len(r.losses) == 14
    # encodes at steps 0, 3, 6 and 9: the replay of step 3 starts from
    # the state its own encode held
    assert len(r.ft.timings["encode"]) == 4


def test_encode_runs_the_kernel_path_once_per_floating_leaf():
    """The diskless encode of a train state takes kernel #3's dispatch for
    every floating leaf of the stacked view (its plain version here).  With
    p = 2 the smoke config's 2 layers split as the full width's 24 do with
    p = 4 (with p = 4 its layer groups stay whole and are kept as they
    are, in both packages)."""
    state = init_state(torch.Generator().manual_seed(0), tsmoke(ARCH))
    view = stack_view(state, 2)
    n_float = sum(1 for x in tree_leaves(view) if x.is_floating_point())
    # params, m and v: 14 stacked leaves each for Qwen2's layout
    assert n_float == 3 * len(tree_leaves(view["params"])) == 42
    ft = FTRuntime(2, FTPolicy(diskless_every=1))
    plain = kenc.plain_calls
    ft.maybe_checkpoint(0, lambda: stack_view(state, 2))
    assert kenc.plain_calls == plain + n_float


def test_what_is_not_ported_raises():
    # every StepOptions field is ported: int8_ef, zero2 and fsdp build
    # (tests/test_torch_step_builders.py holds them to the reference), and
    # what raises is what the reference rejects or cannot trace
    for opts in (StepOptions(grad_compression="int8_ef",
                             defer_grad_reduce=True),
                 StepOptions(zero2=True, defer_grad_reduce=True),
                 StepOptions(fsdp=True)):
        assert callable(build_train_step(tsmoke(ARCH), SHAPE, opts=opts))
    for bad in (StepOptions(grad_compression="int8_ef"),
                StepOptions(grad_compression="int4", defer_grad_reduce=True)):
        with pytest.raises(ValueError, match="grad_compression"):
            build_train_step(tsmoke(ARCH), SHAPE, opts=bad)
    # the drill flags run the pod-loss drill (tests/test_torch_elastic_pods.py
    # holds it to the reference); on the default device it raises without
    # a card rather than falling back
    if not torch.cuda.is_available():
        for flag in (["--kill-pod-at-step", "4"],
                     ["--kill-pod-at-step", "4", "--regrow-at-step", "7"],
                     ["--kill-pod-at-step", "4", "--drill-mesh", "2x2x2"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ttrain.main(flag)


def test_train_without_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(ARCH, steps=1)


def _rmsnorm_drill(mod, monkeypatch):
    """Every checked rmsnorm of ``mod`` gets a +1.0 on its first
    normalized element: the second-moment invariant must trip."""
    orig = mod.rmsnorm_apply

    def drilled(p, x, eps=1e-6, *, check=False, inject=None):
        return orig(p, x, eps, check=check, inject=1.0 if check else inject)
    monkeypatch.setattr(mod, "rmsnorm_apply", drilled)


@pytest.mark.parametrize("drill", [False, True])
@pytest.mark.parametrize("arch,microbatches", [
    ("qwen2-0.5b", 1), ("qwen2-0.5b", 2), ("qwen3-moe-30b-a3b", 1),
    ("jamba-1.5-large-398b", 2)])
def test_invariant_checks_match_reference(monkeypatch, arch, microbatches,
                                          drill):
    """StepOptions(invariant_checks=True): metrics["inv_ok"], the loss (the
    MoE aux loss in it) and the grad norm equal the reference's
    build_train_step on an Auto-axis 1 x 1 mesh; 1.0 on a clean step, 0.0
    under a norm drill (each package's rmsnorm injected alike)."""
    if drill:
        _rmsnorm_drill(jtf, monkeypatch)
        _rmsnorm_drill(ttf, monkeypatch)
    cfg_j, cfg_t = jsmoke(arch), tsmoke(arch)
    shape = ShapeConfig("t", 16, 4, "train")
    mesh = _mesh()
    jo = JOpts(microbatches=microbatches, remat=True, invariant_checks=True)
    with jax.set_mesh(mesh):
        fn, in_sh, out_sh = jbuild(cfg_j, mesh, shape,
                                   jopt.AdamWConfig(**ADAMW), jo)
        jfn = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        jstate = jinit(jax.random.PRNGKey(0), cfg_j, jo)
        batch = jdata.synthetic_batch(
            jdata.DataConfig(cfg_j.vocab_size, 16, 4), 0)
        _, mj = jfn(jax.device_put(jstate, in_sh[0]),
                    jax.device_put({k: jnp.asarray(v)
                                    for k, v in batch.items()}, in_sh[1]))
    step = build_train_step(
        cfg_t, shape, topt.AdamWConfig(**ADAMW),
        StepOptions(microbatches=microbatches, remat=True,
                    invariant_checks=True))
    state = state_from_jax(jax.tree.map(np.asarray, jstate), cfg_t)
    _, mt = step(state, batch)
    assert float(mt["inv_ok"]) == float(mj["inv_ok"]) == \
        (0.0 if drill else 1.0)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)


def test_invariant_checks_reject_deferred_grad_reduce():
    with pytest.raises(ValueError, match="invariant_checks"):
        build_train_step(tsmoke(ARCH), SHAPE,
                         opts=StepOptions(invariant_checks=True,
                                          defer_grad_reduce=True))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-2b", "gemma3-4b",
                                  "granite-34b", "jamba-1.5-large-398b",
                                  "kimi-k2-1t-a32b", "llama-3.2-vision-11b",
                                  "qwen3-moe-30b-a3b", "whisper-large-v3",
                                  "xlstm-350m"])
def test_param_counts_equal_reference(arch):
    """`param_count` and `active_param_count` (experts scaled by k/E per
    stacked leaf, the embedding table left out) at full size, over the
    port's meta shapes and the reference's eval_shape tree."""
    from repro.configs.base import get_config as jget
    from repro_torch.configs.base import get_config as tget
    from repro_torch.train.step import state_shapes
    jp = jax.eval_shape(lambda k: jtf.init_params(k, jget(arch)),
                        jax.random.PRNGKey(0))
    tp = state_shapes(tget(arch))["params"]
    assert ttf.param_count(tp) == jtf.param_count(jp)
    assert ttf.active_param_count(tget(arch)) == \
        jtf.active_param_count(jget(arch))
    assert ttf.active_param_count(tget(arch), tp) == \
        jtf.active_param_count(jget(arch), jp)

"""The step builders of the tuning slice against the reference: the train
step's ``grad_compression="int8_ef"``, ``zero2`` and ``fsdp``, the state's
``ef_residual`` and its specs, ``make_inputs`` and the prefill and serve
steps.

At DP 1 the port's steps are held to the reference's jitted steps on a
one-device ``Auto``-axis mesh (the same numpy batches, a reference state
carried over with ``convert.state_from_jax``); at DP 2 and 4, where the
reference needs as many devices, ``zero2`` and ``fsdp`` are held bit for
bit to the uncompressed deferred step (on the logical mesh they are
layouts), and the compressed reduction to a numpy oracle of the
reference's int8 error feedback on the step's own stacked gradients.

Tolerances: fp32 sums in another order, so uncompressed states agree to
1e-4 of each leaf's largest magnitude (as tests/test_torch_train.py).  The
compressed step rounds each gradient element to one of 255 levels: an
element within fp32 noise of a rounding boundary lands on the other level
in one package, so 2 elements or 0.5 % of a leaf, whichever is more, may
miss that tolerance (measured after 3 steps: 2 of 8192 in one leaf, 1 of
128 in a norm's residual); the residual, a rounding error, agrees to 1 %
of its largest magnitude elsewhere; losses agree to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import list_configs
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig
from repro.configs.base import get_config as jget
from repro.configs.base import smoke_config as jsmoke
from repro.configs.base import valid_cells
from repro.data import pipeline as jdata
from repro.ft.runtime import stack_view as jstack
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train.step import StepOptions as JOpts
from repro.train.step import build_prefill_step as jprefill
from repro.train.step import build_serve_step as jserve
from repro.train.step import build_train_step as jbuild
from repro.train.step import init_state as jinit
from repro.train.step import make_inputs as jinputs
from repro.train.step import state_specs as jstate_specs
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.ft.runtime import ElasticRuntime, stack_view
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.step import (StepOptions, build_prefill_step,
                                    build_serve_step, build_train_step,
                                    make_inputs, state_shapes, state_specs)
from repro_torch.tree import tree_leaves, tree_leaves_with_path
from torch_port_helpers import one_torch_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "qwen2-0.5b"
SHAPE = ShapeConfig("t", 32, 8, "train")
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=12)
RTOL = 1e-4
FLIP_SHARE = 5e-3        # int8 rounding flips allowed per leaf


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _batch(step, shape=SHAPE, seed=0):
    return jdata.synthetic_batch(
        jdata.DataConfig(jsmoke(ARCH).vocab_size, shape.seq_len,
                         shape.global_batch, seed=seed), step)


def _leaves_close(got, want, *, flips=False, rtol=RTOL):
    """Leaf for leaf (the same key path), within ``rtol`` of the leaf's
    largest magnitude; with ``flips``, except at most 2 elements or
    ``FLIP_SHARE`` of the leaf, whichever is more."""
    gl = tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert len(gl) == len(wl)
    for (gp, g), (wp, w) in zip(gl, wl):
        assert jax.tree_util.keystr(wp) == "".join(f"[{k!r}]" for k in gp)
        g, w = to_np(g).astype(np.float64), to_np(w).astype(np.float64)
        assert g.shape == w.shape, gp
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        off = int((np.abs(g - w) > rtol * np.abs(w) + rtol * scale).sum())
        allowed = max(2, int(FLIP_SHARE * w.size)) if flips else 0
        assert off <= allowed, (gp, off, w.size)


# ---------------------------------------------------------------------------
# the train step's options at DP 1 against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(defer_grad_reduce=True, grad_compression="int8_ef"),
    dict(defer_grad_reduce=True, zero2=True),
    dict(fsdp=True),
    dict(defer_grad_reduce=True, zero2=True, grad_compression="int8_ef",
         microbatches=2),
], ids=["int8_ef", "zero2", "fsdp", "int8_ef+zero2+mb2"])
def test_train_step_options_match_reference(kw):
    """Three steps from one state (the compressed ones with the reference's
    zero ``ef_residual`` carried over): losses, grad norms and every leaf
    of the new state, the residual included."""
    jo, to = JOpts(remat=False, **kw), StepOptions(remat=False, **kw)
    mesh = _mesh()
    with jax.set_mesh(mesh):
        fn, in_sh, out_sh = jbuild(jsmoke(ARCH), mesh, SHAPE,
                                   jopt.AdamWConfig(**ADAMW), jo)
        jfn = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        jstate = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                jsmoke(ARCH), jo, mesh))
    assert ("ef_residual" in jstate) == ("grad_compression" in kw)
    state = state_from_jax(jstate, tsmoke(ARCH))
    step = build_train_step(tsmoke(ARCH), SHAPE, topt.AdamWConfig(**ADAMW),
                            to)
    compress = "grad_compression" in kw
    for i in range(3):
        with jax.set_mesh(mesh):
            b = {k: jnp.asarray(v) for k, v in _batch(i).items()}
            jstate, mj = jfn(jax.device_put(jstate, in_sh[0]),
                             jax.device_put(b, in_sh[1]))
        state, mt = step(state, _batch(i))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]),
                                   rtol=1e-3 if compress else 1e-5)
    if compress:
        # the residual is a rounding error, a difference of close numbers:
        # within 1 % of its largest magnitude (a flip moves it a level)
        _leaves_close(state["ef_residual"], jstate["ef_residual"],
                      flips=True, rtol=1e-2)
    state = {k: v for k, v in state.items() if k != "ef_residual"}
    jstate = {k: v for k, v in jstate.items() if k != "ef_residual"}
    _leaves_close(stack_view(state, 1), jstack(jstate, 1), flips=compress)


def test_int8_ef_loss_gap_is_the_references_at_width():
    """The compressed run trails the uncompressed one by a gap that grows
    with the width of the leaves (one int8 scale per stacked leaf: the
    more elements, the more of them round to zero at first): at vocab
    16384 and d_model 128 the gap reaches about 2.5 % of the loss in 10
    steps of lr 1e-3, and the port's gap is the reference's to 1e-3."""
    over = dict(vocab_size=16384, d_model=128, d_ff=256)
    jcfg, tcfg = jsmoke(ARCH).scaled(**over), tsmoke(ARCH).scaled(**over)
    shape = ShapeConfig("t", 32, 16, "train")
    adamw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    data = jdata.DataConfig(jcfg.vocab_size, 32, 16, seed=0)
    mesh = _mesh()
    gaps = {}
    for name, kw in (("ef", dict(defer_grad_reduce=True,
                                 grad_compression="int8_ef")),
                     ("plain", dict(defer_grad_reduce=True))):
        jo, to = JOpts(remat=False, **kw), StepOptions(remat=False, **kw)
        with jax.set_mesh(mesh):
            fn, in_sh, out_sh = jbuild(jcfg, mesh, shape,
                                       jopt.AdamWConfig(**adamw), jo)
            jfn = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
            js = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                jcfg, jo, mesh))
        ts = state_from_jax(js, tcfg)
        step = build_train_step(tcfg, shape, topt.AdamWConfig(**adamw), to)
        losses = []
        for i in range(10):
            b = jdata.synthetic_batch(data, i)
            with jax.set_mesh(mesh):
                js, mj = jfn(jax.device_put(js, in_sh[0]), jax.device_put(
                    {k: jnp.asarray(v) for k, v in b.items()}, in_sh[1]))
            ts, mt = step(ts, b)
            losses.append((float(mj["loss"]), float(mt["loss"])))
        gaps[name] = np.array(losses)
    gap = gaps["ef"] - gaps["plain"]                    # [step, package]
    np.testing.assert_allclose(gap[:, 1], gap[:, 0], rtol=0, atol=1e-3)
    assert gap[-3:, 0].max() > 0.01 * gaps["plain"][-1, 0]


# ---------------------------------------------------------------------------
# DP 2 and 4 on the logical mesh
# ---------------------------------------------------------------------------


def _run(mesh_shape, kw, steps=3, shape=ShapeConfig("t", 32, 16, "train")):
    rt = ElasticRuntime(tsmoke(ARCH), shape, mesh_shape,
                        opts=StepOptions(remat=False, **kw),
                        adamw=topt.AdamWConfig(**ADAMW), device="cpu")
    try:
        state = rt.init_state(0)
        losses = []
        for i in range(steps):
            state, m = rt.train_step(i, state)
            losses.append(float(m["loss"]))
        return state, losses, rt.gen.step_fn
    finally:
        rt.close()


@pytest.mark.parametrize("mesh_shape", [(1, 2, 1), (1, 4, 1)],
                         ids=["dp2", "dp4"])
def test_zero2_and_fsdp_are_layouts(mesh_shape):
    """On the logical mesh zero2 and fsdp change where the reference keeps
    gradients and params, not what the step computes: bit for bit the
    uncompressed deferred step.  zero2's gradient layout is the
    reference's (each leaf's ZeRO dim over the DP axes)."""
    base, lb, _ = _run(mesh_shape, dict(defer_grad_reduce=True))
    for kw in (dict(defer_grad_reduce=True, zero2=True),
               dict(defer_grad_reduce=True, fsdp=True)):
        st, ls, fn = _run(mesh_shape, kw)
        assert ls == lb
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(st), tree_leaves(base)))
        if kw.get("zero2"):
            specs = tree_leaves(fn.grad_specs)
            assert len(specs) == len(tree_leaves(
                stack_view(base["params"], 1)))
            assert any(("pod", "data") in tuple(s) for s in specs)


def _ef_oracle(x, ndp):
    """The reference's int8 error feedback, psum wire, in numpy: x is the
    stacked [ndp, ...] gradient plus residual; returns (mean, residual)."""
    flat = x.reshape(ndp, -1).astype(np.float32)
    scale = np.maximum(np.abs(flat).max(axis=1), np.float32(1e-30)) \
        / np.float32(127.0)
    q = np.clip(np.round(flat / scale[:, None]), -127, 127)
    deq = (q * scale[:, None]).astype(np.float32)
    return (deq.sum(0) / ndp).reshape(x.shape[1:]), (flat - deq).reshape(
        x.shape)


@pytest.mark.parametrize("mesh_shape,ndp", [((1, 2, 1), 2), ((1, 4, 1), 4)],
                         ids=["dp2", "dp4"])
def test_int8_ef_step_against_numpy_oracle(monkeypatch, mesh_shape, ndp):
    """The compressed step reduces the stacked per-shard gradients (the
    same buffer as the uncompressed step's, plus the carried residual) to
    the numpy oracle's mean and residual, step after step; its losses stay
    within 1 % of the uncompressed run's (measured 0.13 % over 10 steps at
    DP 4)."""
    seen = []
    real = tstep.ef_psum_tree

    def capture(grads, residual, axes, n, **kw):
        mean, new_res = real(grads, residual, axes, n, **kw)
        seen.append(([g.clone() for g in grads],
                     [r.clone() for r in tree_leaves(residual)],
                     [m.clone() for m in tree_leaves(mean)],
                     [r.clone() for r in tree_leaves(new_res)]))
        return mean, new_res

    monkeypatch.setattr(tstep, "ef_psum_tree", capture)
    st, losses, _ = _run(mesh_shape, dict(defer_grad_reduce=True,
                                          grad_compression="int8_ef"))
    assert len(seen) == 3
    for i, (grads, res, mean, new_res) in enumerate(seen):
        for g, r, m, nr in zip(grads, res, mean, new_res):
            assert g.shape[0] == ndp
            om, onr = _ef_oracle((g.float() + r).numpy(), ndp)
            scale = float(np.abs(om).max()) + 1e-30
            np.testing.assert_allclose(m.numpy(), om, rtol=1e-6,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(nr.numpy(), onr, rtol=0,
                                       atol=1e-6 * float(np.abs(
                                           g.float().numpy()).max()))
        if i + 1 < len(seen):       # the residual carries to the next step
            for nr, r_next in zip(new_res, seen[i + 1][1]):
                assert torch.equal(nr, r_next)
    base = _run(mesh_shape, dict(defer_grad_reduce=True))[1]
    assert np.max(np.abs(np.subtract(losses, base)) / np.array(base)) < 1e-2
    assert st["ef_residual"]["embed"]["table"].shape[0] == ndp


# ---------------------------------------------------------------------------
# specs, inputs, and the serving steps
# ---------------------------------------------------------------------------

SPEC_MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]


def _spec_leaves(tree, ref):
    if ref:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))
        return [([getattr(k, "key", None) for k in p
                  if isinstance(getattr(k, "key", None), str)], tuple(s),
                 str(s)) for p, s in flat]
    return [([k for k in p if isinstance(k, str)], tuple(s), str(s))
            for p, s in tree_leaves_with_path(tree)]


@pytest.mark.parametrize("shape,axes", SPEC_MESHES,
                         ids=["x".join(map(str, m)) for m, _ in SPEC_MESHES])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_state_specs_with_residual_and_fsdp_equal_reference(arch, shape,
                                                            axes):
    jmesh = AbstractMesh(shape, axes)
    mesh = make_mesh(shape, axes, device="cpu")
    for kw in (dict(grad_compression="int8_ef", defer_grad_reduce=True),
               dict(grad_compression="int8_ef", defer_grad_reduce=True,
                    fsdp=True),
               dict(fsdp=True)):
        jo, to = JOpts(**kw), StepOptions(**kw)
        jst = jax.eval_shape(lambda k: jinit(k, jsmoke(arch), jo, jmesh),
                             jax.random.PRNGKey(0))
        tst = state_shapes(tsmoke(arch), to, mesh)
        if "grad_compression" in kw:
            assert [tuple(x.shape) for x in tree_leaves(tst["ef_residual"])] \
                == [tuple(x.shape) for x in jax.tree.leaves(
                    jst["ef_residual"])]
            assert all(x.dtype == torch.float32
                       for x in tree_leaves(tst["ef_residual"]))
        assert _spec_leaves(state_specs(tst, mesh, to, tsmoke(arch)),
                            False) == \
            _spec_leaves(jstate_specs(jst, jmesh, jo, jsmoke(arch)), True)


@pytest.mark.parametrize("arch", list_configs())
def test_make_inputs_equal_reference(arch):
    """Every valid cell of every config: the same input names, shapes and
    dtypes (meta tensors against ShapeDtypeStructs; zeros on request)."""
    cfg, jcfg = tget(arch), jget(arch)
    for cell in valid_cells(arch):
        shape = JSHAPES[cell]
        got, want = make_inputs(cfg, shape), jinputs(jcfg, shape)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (cell, k)
            assert str(got[k].dtype).replace("torch.", "") == \
                jnp.dtype(want[k].dtype).name, (cell, k)
            assert got[k].device.type == "meta"
    small = ShapeConfig("d", 8, 2, "decode")
    zeros = make_inputs(tsmoke(arch), small, structs=False, device="cpu")
    assert all(not x.any() and x.device.type == "cpu"
               for x in zeros.values())


@pytest.mark.parametrize("arch", list_configs())
def test_prefill_and_serve_steps_match_reference(arch):
    """A prefill of 8 tokens into a 16-slot cache, then one decode step of
    the greedy token: both packages' builders on the same params and
    inputs (frames and image embeddings where the config has them), the
    logits within 1e-5 of their largest magnitude; the shardings the
    builders give are the reference's specs."""
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    b, s = 2, 16
    pshape = ShapeConfig("p", s, b, "prefill")
    dshape = ShapeConfig("d", s, b, "decode")
    mesh = _mesh()
    rs = np.random.RandomState(0)
    toks = rs.randint(0, jcfg.vocab_size, (b, 8)).astype(np.int32)
    extra = {}
    if jcfg.n_enc_layers:
        extra["frames"] = rs.standard_normal(
            (b, jcfg.n_frames, jcfg.d_model)).astype(np.float32)
    if jcfg.n_img_tokens:
        extra["img_emb"] = rs.standard_normal(
            (b, jcfg.n_img_tokens, jcfg.d_model)).astype(np.float32)
    with jax.set_mesh(mesh):
        jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        jpf, jin, jout = jprefill(jcfg, mesh, pshape)
        jsf, _, _ = jserve(jcfg, mesh, dshape)
        jb = {"tokens": jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        jl, jcache = jax.jit(jpf)(jp, jb, jtf.init_cache(jcfg, b, s))
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        db = {"tokens": jnp.asarray(nxt), "pos": jnp.asarray(8, jnp.int32)}
        if "img_emb" in extra:
            db["img_emb"] = jnp.asarray(extra["img_emb"])
        jl2, _ = jax.jit(jsf)(jp, db, jcache)
    params = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tmesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    tpf, tin, tout = build_prefill_step(tcfg, tmesh, pshape)
    tsf, _, _ = build_serve_step(tcfg, tmesh, dshape)
    with torch.no_grad():
        tl, cache = tpf(params, {"tokens": torch.from_numpy(toks),
                                 **{k: torch.from_numpy(v)
                                    for k, v in extra.items()}},
                        ttf.init_cache(tcfg, b, s, device="cpu"))
        tdb = {"tokens": torch.from_numpy(nxt),
               "pos": torch.tensor(8, dtype=torch.int32)}
        if "img_emb" in extra:
            tdb["img_emb"] = torch.from_numpy(extra["img_emb"])
        tl2, _ = tsf(params, tdb, cache)
    for got, want in ((tl, jl), (tl2, jl2)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale)
    # the records: params, inputs and cache in; logits and cache out
    for got, want in ((tin, jin), (tout, jout)):
        g = [(str(x.spec)) for x in tree_leaves(got)]
        w = [str(x.spec) for x in jax.tree.leaves(
            want, is_leaf=lambda x: hasattr(x, "spec"))]
        assert g == w


def test_step_builders_accept_meta_and_dataclass_config():
    """The builders run on meta tensors (what the dry run feeds them) and
    keep the reference's MoE dispatch groups at the DP extent."""
    cfg = tsmoke("qwen3-moe-30b-a3b")
    mesh = make_mesh((4, 1), ("data", "model"), device="meta")
    fn, _, _ = build_serve_step(cfg, mesh, ShapeConfig("d", 16, 4,
                                                       "decode"))
    params = state_shapes(cfg)["params"]
    cache = ttf.init_cache(cfg, 4, 16, device="meta")
    logits, _ = fn(params, make_inputs(cfg, ShapeConfig("d", 16, 4,
                                                        "decode")), cache)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (4, cfg.vocab_size)
    assert tstep._moe_cfg(cfg, 4) == dataclasses.replace(cfg, moe_groups=4)

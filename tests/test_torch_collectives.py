"""The port's checksum-verified reductions and SDC injectors against the JAX
reference.

The reference's `abft_psum` runs inside a collective region; here it runs
under ``jax.vmap(..., axis_name="i")`` over the shards, and the port's
takes the same contributions stacked on a leading axis.  Both see the same
numpy inputs.  Detection (``ok``) and location (``row``, ``col``,
``index``, ``corrected``) must be equal.  The sums run in another order in
the two frameworks, so the reduced values agree to RTOL of the summed
magnitudes; where a fault was repaired, the repaired element also carries
the rounding of the residual it subtracts, a few ulps of ``|delta|``
(measured 1.8e-7 |delta|), so it is held to 1e-6 |delta| on top.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import faults as jfaults
from repro.dist.collectives import abft_psum as jpsum
from repro.dist.collectives import abft_psum_tree as jtree
from repro_torch.chaos import faults as tfaults
from repro_torch.dist.collectives import abft_psum, abft_psum_tree
from torch_port_helpers import RTOL

EXTENTS = (1, 2, 4)
SIZES = (1, 3, 37, 1000, 4099)      # 1: too small to carry 2 checksums
REPAIR_RTOL = 1e-6                  # of |delta|, on a repaired element


def _ref_psum(x, **kw):
    """The reference over the stacked shards: its (y, ok, info) of shard 0
    (every shard holds the same reduced result)."""
    fn = jax.vmap(lambda a: jpsum(a, "i", with_info=True, **kw),
                  axis_name="i")
    y, ok, info = fn(jnp.asarray(x))
    return (np.asarray(y[0]), bool(ok[0]),
            {k: np.asarray(v[0]) for k, v in info.items()})


def _assert_sum_close(got, want, x, delta=0.0):
    scale = float(np.abs(x).sum(axis=0).max())
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * scale + REPAIR_RTOL * abs(delta))


@pytest.mark.parametrize("m", EXTENTS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", ["verify", "correct"])
@pytest.mark.parametrize("how", ["clean", "inject", "inject_local"])
def test_abft_psum_matches_reference(m, n, mode, how):
    rs = np.random.RandomState(1000 * m + n)
    x = rs.standard_normal((m, n)).astype(np.float32)
    shard, delta = m - 1, -3e4 if n % 2 else 1e3
    kw = dict(mode=mode)
    if how == "inject":
        kw["inject"] = (shard, delta)
    elif how == "inject_local":
        vec = np.zeros(m, np.float32)
        vec[shard] = delta
        kw["inject_local"] = vec
    if n < 2 and how != "clean":
        for fn in (lambda: _ref_psum(x, **kw),
                   lambda: abft_psum(torch.from_numpy(x), **kw)):
            with pytest.raises(ValueError, match="too small"):
                fn()
        return
    if how == "inject_local":
        yj, okj, ij = jax.vmap(
            lambda a, d: jpsum(a, "i", mode=mode, inject_local=d,
                               with_info=True),
            axis_name="i")(jnp.asarray(x), jnp.asarray(kw["inject_local"]))
        yj, okj = np.asarray(yj[0]), bool(okj[0])
        ij = {k: np.asarray(v[0]) for k, v in ij.items()}
        kw["inject_local"] = torch.from_numpy(kw["inject_local"])
    else:
        yj, okj, ij = _ref_psum(x, **kw)
    yt, okt, it = abft_psum(torch.from_numpy(x), with_info=True, **kw)
    assert bool(okt) == okj
    assert okt.dtype == torch.bool and okt.dim() == 0
    for k in ("row", "col", "index", "corrected"):
        assert int(it[k]) == int(ij[k]), k
    np.testing.assert_allclose(float(it["magnitude"]), float(ij["magnitude"]),
                               rtol=1e-4, atol=RTOL * abs(delta))
    injected = how != "clean"
    assert okj == (not injected)
    if injected and mode == "correct":
        assert bool(it["corrected"])
    _assert_sum_close(yt.numpy(), yj, x, delta if injected else 0.0)


def test_abft_psum_keeps_shape_dtype_and_checks_arguments():
    x = torch.randn(2, 3, 5, dtype=torch.bfloat16)
    y, ok = abft_psum(x)
    assert y.shape == (3, 5) and y.dtype == torch.bfloat16 and bool(ok)
    with pytest.raises(ValueError, match="unknown mode"):
        abft_psum(x, mode="fix")
    with pytest.raises(ValueError, match="f >= 2"):
        abft_psum(x, f=1, mode="correct")
    with pytest.raises(ValueError, match="not both"):
        abft_psum(x, inject=(0, 1.0), inject_local=torch.zeros(2))
    with pytest.raises(ValueError, match="leading stacked"):
        abft_psum(x, axes=("data",))
    # f = 1: row sums only, detect without locating
    y, ok, info = abft_psum(torch.ones(1, 64), f=1, mode="verify",
                            inject=(0, 1e3), with_info=True)
    assert not bool(ok) and int(info["row"]) == -1


def _tree(rs, m):
    """Leaves from too small to protect up to a few thousand elements."""
    return {"a": rs.standard_normal((m, 1)).astype(np.float32),
            "b": rs.standard_normal((m, 3, 7)).astype(np.float32),
            "c": [rs.standard_normal((m, 50, 40)).astype(np.float32),
                  rs.standard_normal((m, 33)).astype(np.float32)]}


@pytest.mark.parametrize("m", EXTENTS)
@pytest.mark.parametrize("mode", ["verify", "correct"])
@pytest.mark.parametrize("inject", [None, (0, 1e3),
                                    ((0, 1e3), (0, -3e4)),
                                    ((0, 2e3), (0, 1e3), (0, -5e3))])
def test_abft_psum_tree_matches_reference(m, mode, inject):
    rs = np.random.RandomState(m)
    tree = _tree(rs, m)
    if inject is not None and not isinstance(inject[0], tuple):
        inject = (inject[0] % m, inject[1])
    fn = jax.vmap(lambda t: jtree(t, "i", m, mode=mode, inject=inject),
                  axis_name="i")
    gj, okj = fn(jax.tree.map(jnp.asarray, tree))
    tt = {"a": torch.from_numpy(tree["a"]), "b": torch.from_numpy(tree["b"]),
          "c": [torch.from_numpy(c) for c in tree["c"]]}
    gt, okt = abft_psum_tree(tt, 0, m, mode=mode, inject=inject)
    assert bool(okt) == bool(okj[0]) == (inject is None)
    events = [] if inject is None else \
        [inject] if not isinstance(inject[0], tuple) else list(inject)
    delta = max((abs(d) for _, d in events), default=0.0)
    for (want, x), got in zip(
            [(gj["a"], tree["a"]), (gj["b"], tree["b"]),
             (gj["c"][0], tree["c"][0]), (gj["c"][1], tree["c"][1])],
            [gt["a"], gt["b"], gt["c"][0], gt["c"][1]]):
        # the mean over m shards, scaled back to the sum
        _assert_sum_close(got.numpy() * m, np.asarray(want[0]) * m, x,
                          delta)


def test_abft_psum_tree_events_need_eligible_leaves():
    tree = {"a": torch.ones(1, 1), "b": torch.ones(1, 8)}
    with pytest.raises(ValueError, match="only 1 qualify"):
        abft_psum_tree(tree, 0, 1, inject=((0, 1.0), (0, 2.0)))
    with pytest.raises(ValueError, match="stacked over 2"):
        abft_psum_tree(tree, 0, 2)
    y, ok = abft_psum_tree({}, 0, 1)
    assert y == {} and bool(ok)


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extent,shard,delta", [(1, 0, 1e4), (4, 2, -3e4),
                                                (2, 1, 0.0)])
def test_scatter_delta_matches_reference(extent, shard, delta):
    want = np.asarray(jfaults.scatter_delta(extent, shard, delta))
    got = tfaults.scatter_delta(extent, shard, delta)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(IndexError):
        tfaults.scatter_delta(extent, extent, delta)


@pytest.mark.parametrize("events", [
    ((1, 0, 1e4),),
    ((2, 0, 1e3), (2, 1, -3e4), (4, 0, 5.0), (2, 0, 1e3)),
    ((0, 3, 1.0), (5, 1, 2.0), (5, 1, 3.0)),
])
def test_sdc_injector_matches_reference(events):
    jp, tp = jfaults.SDCPlan(events), tfaults.SDCPlan(events)
    assert tp.events == jp.events
    j1, t1 = jfaults.SDCInjector(jp), tfaults.SDCInjector(tp)
    j2, t2 = jfaults.SDCInjector(jp), tfaults.SDCInjector(tp)
    for step in range(7):
        assert t1.check_all(step) == j1.check_all(step)
        assert t1.check_all(step) == j1.check_all(step) == ()
        while True:
            got, want = t2.check(step), j2.check(step)
            assert got == want
            if got is None:
                break
    for s in range(7):
        assert tp.events_at(s) == jp.events_at(s)


# ---------------------------------------------------------------------------
# int8 error feedback (ef_psum_tree) and its wire accounting
# ---------------------------------------------------------------------------

EF_NDP = 4


def _ef_tree(rs, ndp=EF_NDP):
    return {"w": rs.standard_normal((ndp, 8, 16)).astype(np.float32),
            "b": rs.standard_normal((ndp, 33)).astype(np.float32)}


def _ref_ef(grads, res, wire, ndp=EF_NDP):
    from repro.dist.collectives import ef_psum_tree as jef
    out, new_res = jax.vmap(
        lambda g, r: jef(g, r, ("dp",), ndp, wire=wire), axis_name="dp")(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in res.items()})
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in new_res.items()})


@pytest.mark.parametrize("wire", ["psum", "int8"])
def test_ef_psum_tree_matches_reference(rs, wire):
    """The reference under ``jax.vmap(axis_name="dp")`` (every shard ends
    with the same mean) against the port on the stacked shards, from a
    nonzero residual: the int8 payloads are the reference's (its mean and
    residual are rebuilt from them exactly), the means agree to 1e-6 of
    their magnitude and the residuals to 1e-6 of the gradients'."""
    from repro_torch.dist.collectives import ef_psum_tree
    grads = _ef_tree(rs)
    res = {k: (0.01 * rs.standard_normal(v.shape)).astype(np.float32)
           for k, v in grads.items()}
    want, want_res = _ref_ef(grads, res, wire)
    got, got_res, info = ef_psum_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in res.items()}, 0, EF_NDP,
        wire=wire, with_info=True)
    for i, k in enumerate(sorted(grads)):
        mean = want[k][0]
        np.testing.assert_array_equal(want[k], np.broadcast_to(
            mean, want[k].shape))
        np.testing.assert_allclose(got[k].numpy(), mean, rtol=1e-6,
                                   atol=1e-6 * np.abs(mean).max())
        np.testing.assert_allclose(got_res[k].numpy(), want_res[k], rtol=0,
                                   atol=1e-6 * np.abs(grads[k]).max())
        x = grads[k] + res[k]
        q, scale = info[i]["q"].numpy(), info[i]["scale"].numpy()
        assert q.dtype == np.int8 and np.abs(q).max() <= 127
        n = x[0].size
        if wire == "psum":
            # the payloads the reference dequantized: its residual is
            # x - q * scale, per shard
            deq = q.reshape(EF_NDP, -1) * scale[:, None]
            np.testing.assert_array_equal(
                (x.reshape(EF_NDP, -1) - deq).reshape(x.shape),
                want_res[k])
        else:
            # the requantized segments: the reference's mean IS q2 * s2
            q2, s2 = info[i]["q2"].numpy(), info[i]["scale2"].numpy()
            np.testing.assert_array_equal(
                (q2.astype(np.float32) * s2[:, None]).reshape(-1)[:n],
                mean.reshape(-1))
            assert q.shape == (EF_NDP, -(-n // EF_NDP) * EF_NDP)


@pytest.mark.parametrize("wire", ["psum", "int8"])
def test_ef_residual_feedback_converges(rs, wire):
    """The reference's convergence test on the port: reducing the same
    gradients 20 times, the running mean of the outputs converges to the
    exact mean (the residual re-injects what int8 dropped), and the
    residuals stay bounded; both packages' running means agree."""
    from repro_torch.dist.collectives import ef_psum_tree
    grads = _ef_tree(rs)
    ref = np.mean(grads["w"], axis=0)
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    res = {k: torch.zeros_like(v) for k, v in tg.items()}
    jres = {k: np.zeros_like(v) for k, v in grads.items()}
    outs, jouts = [], []
    for _ in range(20):
        out, res = ef_psum_tree(tg, res, 0, EF_NDP, wire=wire)
        jout, jres = _ref_ef(grads, jres, wire)
        outs.append(out["w"].numpy())
        jouts.append(jout["w"][0])
    first_err = np.max(np.abs(outs[0] - ref))
    running = np.mean(outs, axis=0)
    assert np.max(np.abs(running - ref)) < 0.25 * first_err
    assert float(res["w"].abs().max()) < 1.0
    np.testing.assert_allclose(running, np.mean(jouts, axis=0), rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_ef_psum_tree_checks_its_arguments():
    from repro_torch.dist.collectives import ef_psum_tree
    g = {"w": torch.ones((2, 3))}
    with pytest.raises(ValueError, match="wire"):
        ef_psum_tree(g, g, 0, 2, wire="fp8")
    with pytest.raises(ValueError, match="stacked"):
        ef_psum_tree(g, g, 0, 4)
    with pytest.raises(ValueError, match="stacked shard axis"):
        ef_psum_tree(g, g, ("dp",), 2)
    # at one shard the int8 wire is the psum wire, as in the reference
    a, ra = ef_psum_tree({"w": torch.ones((1, 3))},
                         {"w": torch.zeros((1, 3))}, 0, 1, wire="int8")
    b, rb = ef_psum_tree({"w": torch.ones((1, 3))},
                         {"w": torch.zeros((1, 3))}, 0, 1, wire="psum")
    assert torch.equal(a["w"], b["w"]) and torch.equal(ra["w"], rb["w"])


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    """(the reference's eval_shape params, the port's meta params)."""
    from repro.configs.base import get_config as jget
    from repro.models import transformer as jtf
    from repro_torch.configs.base import get_config as tget
    from repro_torch.train.step import state_shapes
    jp = jax.eval_shape(lambda k: jtf.init_params(k, jget(arch)),
                        jax.random.PRNGKey(0))
    return jp, state_shapes(tget(arch))["params"]


@pytest.mark.parametrize("ndp", [1, 2, 16, 256])
def test_ef_wire_bytes_equal_reference_for_every_config(ndp):
    """`ef_wire_bytes` over the port's meta param shapes equals the
    reference's over its ``eval_shape`` trees, for all ten configs."""
    from repro.configs import list_configs
    from repro.dist.collectives import ef_wire_bytes as jwire
    from repro_torch.dist.collectives import ef_wire_bytes
    for arch in list_configs():
        jp, tp = _param_shapes(arch)
        got = ef_wire_bytes(tp, ndp)
        assert got == jwire(jp, ndp), arch
        if ndp > 1:
            assert 3.9 < got["saving"] <= 4.0

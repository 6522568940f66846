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

"""The port's MoE FFN against the JAX reference's: the same params
(numpy copies) and inputs give the same output and aux loss for 1, 2 and 4
dispatch groups, on the dropless path and on a capacity-dropping one (more
than 4096 assignments in a group), and the reference's own identities
(group invariance, finite gradients that reach the router) hold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from torch_port_helpers import to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(spec, seed):
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), jmoe.MoESpec(*spec))
    pt = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), pj)
    return pj, pt


def _both(pj, pt, x, spec):
    yj, auxj = jmoe.moe_apply(pj, jnp.asarray(x), jmoe.MoESpec(*spec))
    yt, auxt = tmoe.moe_apply(pt, torch.from_numpy(x), tmoe.MoESpec(*spec))
    return (to_np(yt), float(auxt)), (np.asarray(yj), float(auxj))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_dropless_matches_reference(rs, groups):
    spec = (16, 32, 4, 2, 1.25, groups)
    pj, pt = _params(spec, 0)
    x = rs.standard_normal((4, 8, 16)).astype(np.float32)
    (yt, at), (yj, aj) = _both(pj, pt, x, spec)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(at, aj, **TOL)
    assert at > 0


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_capacity_drops_match_reference(rs, groups):
    """4 x 2100 tokens, top-2 of 4 experts: every group holds more than
    4096 assignments, so the buffer has capacity ceil(N/E * 0.5) and drops
    the same tokens in both packages."""
    spec = (16, 32, 4, 2, 0.5, groups)
    pj, pt = _params(spec, 1)
    x = rs.standard_normal((4, 2100, 16)).astype(np.float32)
    n = 4 * 2100 // groups * 2
    assert n > 4096 and tmoe.moe_capacity(n, tmoe.MoESpec(*spec)) < n // 4
    (yt, at), (yj, aj) = _both(pj, pt, x, spec)
    np.testing.assert_allclose(yt, yj, **TOL)
    np.testing.assert_allclose(at, aj, **TOL)
    # drops happened: some token got no expert output at all
    assert np.any(np.all(yt == 0.0, axis=-1))


def test_group_invariance(rs):
    """With the dropless floor, grouping does not change the result."""
    s1 = tmoe.MoESpec(16, 32, 4, 2, groups=1)
    s4 = tmoe.MoESpec(16, 32, 4, 2, groups=4)
    _, pt = _params(tuple(s1), 1)
    x = torch.from_numpy(rs.standard_normal((4, 8, 16)).astype(np.float32))
    y1, _ = tmoe.moe_apply(pt, x, s1)
    y4, _ = tmoe.moe_apply(pt, x, s4)
    np.testing.assert_allclose(to_np(y1), to_np(y4), **TOL)


def test_grad_finite_and_matches_reference(rs):
    spec = (8, 16, 4, 2)
    pj, pt = _params(spec, 2)
    x = rs.standard_normal((2, 4, 8)).astype(np.float32)

    def loss_j(p):
        y, aux = jmoe.moe_apply(p, jnp.asarray(x), jmoe.MoESpec(*spec))
        return jnp.sum(y ** 2) + 0.01 * aux

    gj = jax.grad(loss_j)(pj)
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), pt)
    y, aux = tmoe.moe_apply(live, torch.from_numpy(x), tmoe.MoESpec(*spec))
    loss = torch.sum(y ** 2) + 0.01 * aux
    leaves, tdef = jax.tree.flatten(live)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    gt = jax.tree.unflatten(tdef, list(grads))
    # the router receives gradient through the combine weights
    assert float(gt["router"]["w"].abs().max()) > 0
    for a, b in zip(jax.tree.leaves(gt), jax.tree.leaves(gj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))

"""The port's Mamba, mLSTM and sLSTM mixers against the JAX reference's on
the same params (numpy copies) and inputs: the full-sequence forms, their
post-sequence states and each decode step, in fp32 with fp32 state.  Then
the reference's own identities on the port: the chunked forms equal the
step-by-step recurrence for chunks 4, 8 and 32, a prefill's state
continues exactly, and gradients stay finite (mLSTM with forget gates
small enough that the unmasked pairwise decay would overflow)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmb
from repro.models import xlstm as jxl
from repro_torch.models import mamba as tmb
from repro_torch.models import xlstm as txl
from torch_port_helpers import to_np

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKS = [4, 8, 32]


def _tt(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got, want, **tol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **(tol or TOL))


MIXERS = {
    # name: (reference init, spec), port apply / decode / init_state
    "mamba": (jmb.mamba_init, jmb.MambaSpec(16, 4, 3, 2),
              tmb.mamba_apply, tmb.mamba_decode_step, tmb.mamba_init_state,
              jmb.mamba_apply, jmb.mamba_decode_step, jmb.mamba_init_state),
    "mlstm": (jxl.mlstm_init, jxl.XLSTMSpec(16, 2),
              txl.mlstm_apply, txl.mlstm_decode_step, txl.mlstm_init_state,
              jxl.mlstm_apply, jxl.mlstm_decode_step, jxl.mlstm_init_state),
    "slstm": (jxl.slstm_init, jxl.XLSTMSpec(16, 2),
              txl.slstm_apply, txl.slstm_decode_step, txl.slstm_init_state,
              jxl.slstm_apply, jxl.slstm_decode_step, jxl.slstm_init_state),
}


def _setup(name, seed=0):
    init, spec, *fns = MIXERS[name]
    pj = init(jax.random.PRNGKey(seed), spec)
    return spec, pj, _tt(pj), fns


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_apply_and_state_match_reference(rs, name):
    spec, pj, pt, (t_apply, _, _, j_apply, _, _) = _setup(name)
    x = rs.standard_normal((2, 37, 16)).astype(np.float32)
    yj, sj = j_apply(pj, jnp.asarray(x), spec, return_state=True)
    yt, st = t_apply(pt, torch.from_numpy(x), spec, return_state=True)
    _close(yt, yj)
    assert sorted(st) == sorted(sj)
    _close({k: st[k] for k in sorted(st)}, {k: sj[k] for k in sorted(sj)})


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_decode_step_matches_reference(rs, name):
    spec, pj, pt, (_, t_dec, t_init, _, j_dec, j_init) = _setup(name, 1)
    x = rs.standard_normal((2, 5, 16)).astype(np.float32)
    sj = j_init(spec, 2)
    st = t_init(spec, 2)
    for i in range(5):
        yj, sj = j_dec(pj, jnp.asarray(x[:, i:i + 1]), sj, spec)
        yt, st = t_dec(pt, torch.from_numpy(x[:, i:i + 1]), st, spec)
        _close(yt, yj)
        _close({k: st[k] for k in sorted(st)}, {k: sj[k] for k in sorted(sj)})


def _stepwise(pt, x, spec, t_dec, t_init):
    st = t_init(spec, x.shape[0])
    outs = []
    for i in range(x.shape[1]):
        y, st = t_dec(pt, x[:, i:i + 1], st, spec)
        outs.append(y)
    return torch.cat(outs, dim=1), st


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", ["mamba", "mlstm"])
def test_chunked_equals_stepwise(rs, name, chunk):
    spec, _, pt, (t_apply, t_dec, t_init, *_) = _setup(name)
    x = torch.from_numpy(rs.standard_normal((2, 24, 16)).astype(np.float32))
    y_par = t_apply(pt, x, spec, chunk=chunk)
    y_seq, _ = _stepwise(pt, x, spec, t_dec, t_init)
    np.testing.assert_allclose(to_np(y_par), to_np(y_seq), **TOL)


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_prefill_state_continues_exactly(rs, name):
    spec, _, pt, (t_apply, t_dec, _, *_) = _setup(name, 2)
    x = torch.from_numpy(rs.standard_normal((1, 20, 16)).astype(np.float32))
    kw = {} if name == "slstm" else {"chunk": 8}
    y_full = t_apply(pt, x, spec, **kw)
    y_pre, st = t_apply(pt, x[:, :12], spec, return_state=True, **kw)
    outs = [y_pre]
    for i in range(12, 20):
        yi, st = t_dec(pt, x[:, i:i + 1], st, spec)
        outs.append(yi)
    np.testing.assert_allclose(to_np(torch.cat(outs, 1)), to_np(y_full),
                               **TOL)


def _grads(apply, p, x, spec, **kw):
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), p)
    leaves, _ = jax.tree.flatten(live)
    loss = torch.sum(apply(live, torch.from_numpy(x), spec, **kw) ** 2)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_grads_finite_and_match_reference(rs, name):
    spec, pj, pt, (t_apply, _, _, j_apply, _, _) = _setup(name, 3)
    x = rs.standard_normal((1, 32, 16)).astype(np.float32)
    kw = {} if name == "slstm" else {"chunk": 32}
    gj = jax.grad(lambda p: jnp.sum(j_apply(p, jnp.asarray(x), spec, **kw)
                                    ** 2))(pj)
    grads = _grads(t_apply, pt, x, spec, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for a, b in zip(grads, jax.tree.leaves(gj)):
        b = np.asarray(b)
        np.testing.assert_allclose(to_np(a), b, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(b).max()),
                                                   1.0))


def test_mlstm_grads_finite_with_small_forget_gates_unlike_reference(rs):
    """Forget gates pushed near 0 (wf scaled by 40, less 2): the pairwise
    decay exponent above the diagonal reaches hundreds.  The reference
    takes exp of it unmasked and its gradient is NaN; the port masks the
    exponent first, and its gradient equals the step-by-step
    recurrence's."""
    spec, pj, _, (t_apply, t_dec, t_init, j_apply, _, _) = _setup("mlstm", 3)
    pj = dict(pj, wf={"w": pj["wf"]["w"] * 40.0 - 2.0})
    pt = _tt(pj)
    x = rs.standard_normal((1, 32, 16)).astype(np.float32)
    gj = jax.grad(lambda p: jnp.sum(j_apply(p, jnp.asarray(x), spec,
                                            chunk=32) ** 2))(pj)
    assert not all(bool(jnp.all(jnp.isfinite(g)))
                   for g in jax.tree.leaves(gj))
    grads = _grads(t_apply, pt, x, spec, chunk=32)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    seq = _grads(lambda p, xx, s: _stepwise(p, xx, s, t_dec, t_init)[0],
                 pt, x, spec)
    for a, b in zip(grads, seq):
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=1e-4,
                                   atol=1e-5 * max(float(np.abs(b).max()),
                                                   1.0))


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_apply_from_a_state_continues_the_sequence(rs, name):
    """The port's ``state=`` (a chunked prefill's carried state): two
    applies, the second from the first's state, equal one apply."""
    spec, _, pt, (t_apply, *_) = _setup(name, 4)
    x = torch.from_numpy(rs.standard_normal((2, 21, 16)).astype(np.float32))
    y_full, s_full = t_apply(pt, x, spec, return_state=True)
    y1, st = t_apply(pt, x[:, :9], spec, return_state=True)
    y2, s2 = t_apply(pt, x[:, 9:], spec, return_state=True, state=st)
    np.testing.assert_allclose(to_np(torch.cat([y1, y2], 1)), to_np(y_full),
                               **TOL)
    for k in s_full:
        np.testing.assert_allclose(to_np(s2[k]), to_np(s_full[k]), **TOL)

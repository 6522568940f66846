"""The FA-2 backward of the port's chunked attention (`models.attention.
_Flash`) against the reference's custom VJP (``jax.grad`` through its
``_sdpa_flash``) on the same numpy inputs: causal, sliding window, softcap
and GQA, where ``sk`` is a multiple of the chunk (the reference pads a
ragged last chunk, which is wrong there); the ragged case against autograd
through the dense path.  Also: a query row whose whole chunk is masked
gets zero gradient from it (no NaN through the softcap's derivative), the
backward stores no [Sq, Sk] array, and a train step at ``seq >
flash_threshold`` takes it.

Tolerance: fp32 sums run in another order, so gradients agree to 1e-4 of
each tensor's largest magnitude (measured below 2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn
from torch_port_helpers import assert_close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-4


def _inputs(rs, b, sq, sk, g_kv, g, d):
    q = rs.standard_normal((b, sq, g_kv, g, d)).astype(np.float32)
    k = rs.standard_normal((b, sk, g_kv, d)).astype(np.float32)
    v = rs.standard_normal((b, sk, g_kv, d)).astype(np.float32)
    w = rs.standard_normal((b, sq, g_kv, g, d)).astype(np.float32)
    return q, k, v, w


def _port_grads(q, k, v, w, pos, kc, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    p = torch.from_numpy(pos)
    o = tattn._sdpa_flash(qt, kt, vt, q_pos=p, k_pos=p, kc=kc, **kw)
    torch.sum(o * torch.from_numpy(w)).backward()
    return o.detach(), (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("causal,window,softcap,g", [
    (True, None, None, 2),        # causal GQA
    (True, 24, None, 2),          # sliding window
    (True, None, 5.0, 1),         # softcap (gemma2-style), MHA
    (True, 20, 30.0, 3),          # window + softcap, GQA 3
    (False, None, None, 2),       # bidirectional
])
def test_fa2_gradients_match_reference(rs, causal, window, softcap, g):
    b, s, g_kv, d, kc = 2, 64, 2, 8, 16
    q, k, v, w = _inputs(rs, b, s, s, g_kv, g, d)
    pos = np.arange(s)
    kw = dict(scale=d ** -0.5, softcap=softcap, causal=causal, window=window)

    def jloss(q_, k_, v_):
        o = jattn._sdpa_flash(q_, k_, v_, q_pos=jnp.asarray(pos),
                              k_pos=jnp.asarray(pos), kc=kc, **kw)
        return jnp.sum(o * w)

    want_o = jattn._sdpa_flash(*map(jnp.asarray, (q, k, v)),
                               q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                               kc=kc, **kw)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    o, got = _port_grads(q, k, v, w, pos, kc, **kw)
    assert_close(o, want_o, rtol=RTOL)
    for gt, exp in zip(got, want):
        assert torch.isfinite(gt).all()
        assert_close(gt, exp, rtol=RTOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_ragged_last_chunk_matches_dense_autograd(rs, window, softcap):
    """sk % kc != 0: the port takes the short last chunk as it is; its
    gradients equal autograd through the dense masked softmax."""
    b, s, g_kv, g, d, kc = 1, 70, 2, 2, 8, 16
    q, k, v, w = _inputs(rs, b, s, s, g_kv, g, d)
    pos = np.arange(s)
    kw = dict(scale=d ** -0.5, softcap=softcap, causal=True, window=window)
    o, got = _port_grads(q, k, v, w, pos, kc, **kw)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    p = torch.from_numpy(pos)
    mask = tattn._mask(p, p, causal=True, window=window)
    od = tattn._sdpa_dense(qt, kt, vt, scale=kw["scale"], softcap=softcap,
                           mask=mask)
    torch.sum(od * torch.from_numpy(w)).backward()
    assert_close(o, od.detach(), rtol=RTOL)
    for gt, exp in zip(got, (qt.grad, kt.grad, vt.grad)):
        assert_close(gt, exp, rtol=RTOL)


def test_fully_masked_chunk_rows_give_zero_not_nan(rs):
    """With a window of 8 and chunks of 16, the rows of the last chunk see
    nothing of the first: p = 0 there, and the softcap's derivative on the
    masked -1e30 scores is guarded (0 * inf would be NaN)."""
    b, s, g_kv, g, d, kc = 1, 64, 1, 1, 8, 16
    q, k, v, w = _inputs(rs, b, s, s, g_kv, g, d)
    pos = np.arange(s)
    o, (gq, gk, gv) = _port_grads(q, k, v, w, pos, kc, scale=d ** -0.5,
                                  softcap=20.0, causal=True, window=8)
    for x in (o, gq, gk, gv):
        assert torch.isfinite(x).all()
    # weight only on queries 56..63: with the window they see keys 49..63,
    # so no key of the first three chunks gets a gradient
    wq = np.zeros_like(w)
    wq[:, 56:] = w[:, 56:]
    _, (_, gk2, gv2) = _port_grads(q, k, v, wq, pos, kc, scale=d ** -0.5,
                                   softcap=20.0, causal=True, window=8)
    assert float(gk2[:, :48].abs().max()) == 0.0
    assert float(gv2[:, :48].abs().max()) == 0.0


class _Biggest(torch.utils._python_dispatch.TorchDispatchMode):
    """The largest tensor any op produces."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_backward_stores_no_score_matrix(rs):
    """Through `_Flash` no op (forward or backward) makes a tensor as large
    as the [B, KV, g, Sq, Sk] scores; autograd through the chunk loop of
    the forward keeps every chunk's probabilities, together that size."""
    b, s, g_kv, g, d, kc = 1, 256, 1, 2, 8, 32
    q, k, v, w = _inputs(rs, b, s, s, g_kv, g, d)
    pos = np.arange(s)
    kw = dict(scale=d ** -0.5, softcap=None, causal=True, window=None)
    with _Biggest() as big:
        _port_grads(q, k, v, w, pos, kc, **kw)
    assert big.most <= b * g_kv * g * s * kc          # one chunk's scores
    assert big.most < b * g_kv * g * s * s


def test_train_step_over_flash_threshold_takes_fa2(monkeypatch):
    """A loss at seq > flash_threshold (1024) differentiates through
    `_Flash`, and its gradients equal those of the forward-only chunk loop
    under autograd (the path it replaces)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models import transformer as ttf
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = smoke_config("qwen2-0.5b")
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, 1040)))
    labs = torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, 1040)))
    calls = []
    real = tattn._Flash.backward

    def counting(ctx, do):
        calls.append(do.shape)
        return real(ctx, do)

    monkeypatch.setattr(tattn._Flash, "backward", staticmethod(counting))
    grads = {}
    for name in ("fa2", "autograd"):
        if name == "autograd":
            monkeypatch.setattr(
                tattn, "_sdpa_flash",
                lambda q, k, v, *, q_pos, k_pos, **kw: tattn._flash_fwd_impl(
                    q, k, v, q_pos, k_pos, **kw)[0])
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = ttf.loss_fn(tree_unflatten(params, live), toks, labs, cfg)
        grads[name] = torch.autograd.grad(loss, live)
    assert len(calls) == cfg.n_layers
    for a, b_ in zip(grads["fa2"], grads["autograd"]):
        scale = float(b_.abs().max())
        assert torch.allclose(a, b_, rtol=RTOL, atol=RTOL * scale + 1e-12)

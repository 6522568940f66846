"""The FA-2 backward of the port's chunked attention (`models.attention.
_Flash`) against the reference's custom VJP (``jax.grad`` through its
``_sdpa_flash``) on the same numpy inputs: causal, sliding window, softcap
and GQA, where ``sk`` is a multiple of the chunk (the reference pads a
ragged last chunk, which is wrong there); the ragged case against autograd
through the dense path.  Each takes both routes of the port: every chunk
over every query row (positions the host does not know) and each chunk
over the rows that can see it (``aligned``, as the layers run it where
they build the positions themselves).  Also: a query row whose whole chunk is masked
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
from flash_oracle import oracle_bwd, oracle_fwd, oracle_scores
from torch_port_helpers import assert_close

RTOL = 1e-4


def _inputs(rs, b, sq, sk, g_kv, g, d):
    q = rs.standard_normal((b, sq, g_kv, g, d)).astype(np.float32)
    k = rs.standard_normal((b, sk, g_kv, d)).astype(np.float32)
    v = rs.standard_normal((b, sk, g_kv, d)).astype(np.float32)
    w = rs.standard_normal((b, sq, g_kv, g, d)).astype(np.float32)
    return q, k, v, w


def _port_grads(q, k, v, w, pos, kc, aligned=False, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    p = torch.from_numpy(pos)
    o = tattn._sdpa_flash(qt, kt, vt, q_pos=p, k_pos=p, kc=kc,
                          aligned=aligned, **kw)
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
    for aligned in (False, True):
        o, got = _port_grads(q, k, v, w, pos, kc, aligned, **kw)
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
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    p = torch.from_numpy(pos)
    mask = tattn._mask(p, p, causal=True, window=window)
    od = tattn._sdpa_dense(qt, kt, vt, scale=kw["scale"], softcap=softcap,
                           mask=mask)
    torch.sum(od * torch.from_numpy(w)).backward()
    for aligned in (False, True):
        o, got = _port_grads(q, k, v, w, pos, kc, aligned, **kw)
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


# ---------------------------------------------------------------------------
# Chunk skipping: each KV chunk only for the query rows that see it, held to
# the reference and to the all-chunks loop (`flash_oracle`)
# ---------------------------------------------------------------------------
SKIP_CASES = {   # causal, window, softcap, g, s, kc, offset of q_pos = k_pos
    "causal-gqa": (True, None, None, 2, 64, 16, 0),
    "window-narrower-than-kc": (True, 8, None, 1, 64, 16, 0),
    "window-wider-than-kc": (True, 40, None, 2, 64, 16, 0),
    "window-crossing-chunk-edges": (True, 20, 30.0, 3, 64, 16, 0),
    "softcap-mha": (True, None, 5.0, 1, 64, 16, 0),
    "ragged-last-chunk": (True, None, None, 2, 70, 16, 0),
    "ragged-window-softcap": (True, 24, 30.0, 2, 70, 16, 0),
    "equal-offset": (True, 24, None, 2, 64, 16, 37),
    "bidirectional": (False, None, None, 2, 64, 16, 0),
    "bidirectional-window": (False, 12, None, 2, 64, 16, 0),
}

FWD_RTOL = 2e-6      # fp32 rounding: the products run at other shapes


def _case(rs, name):
    causal, window, softcap, g, s, kc, off = SKIP_CASES[name]
    q, k, v, w = _inputs(rs, 2, s, s, 2, g, 8)
    kw = dict(scale=8 ** -0.5, softcap=softcap, causal=causal,
              window=window, kc=kc)
    return (q, k, v, w), off + np.arange(s), kw


def _reference(q, k, v, w, pos, *, kc, **kw):
    """The reference's o and gradients of ``sum(o * w)``: its chunked path
    where ``sk % kc == 0``, its dense masked softmax otherwise (its chunked
    path pads a ragged last chunk with keys that causality lets through)."""
    jp = jnp.asarray(pos)
    if q.shape[1] % kc == 0:
        def attend(q_, k_, v_):
            return jattn._sdpa_flash(q_, k_, v_, q_pos=jp, k_pos=jp, kc=kc,
                                     **kw)
    else:
        mask = jattn._mask(jp, jp, causal=kw["causal"], window=kw["window"])

        def attend(q_, k_, v_):
            return jattn._sdpa_dense(q_, k_, v_, scale=kw["scale"],
                                     softcap=kw["softcap"], mask=mask)
    args = tuple(map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(attend(*a) * w),
                     argnums=(0, 1, 2))(*args)
    return attend(*args), grads


def _rows_total():
    c = tattn.obs.counter("repro_flash_chunk_rows_total")
    return {(kd, dr): c.value(kind=kd, direction=dr)
            for kd in ("computed", "skipped") for dr in ("fwd", "bwd")}


@pytest.mark.parametrize("name", sorted(SKIP_CASES))
def test_chunk_skipping_matches_reference(rs, name):
    """With host-known positions each chunk takes only the rows that see
    it.  o and the gradients equal the reference's (`_reference`), and o
    and lse equal the all-chunks loop to fp32 rounding, its gradients to
    the file's tolerance; the forward and the backward skip the same
    rows."""
    (q, k, v, w), pos_np, kw = _case(rs, name)
    pos = torch.from_numpy(pos_np)
    want_o, want = _reference(q, k, v, w, pos_np, **kw)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    oracle_o, oracle_lse = oracle_fwd(qt, kt, vt, pos, pos, **kw)
    o, lse = tattn._flash_fwd_impl(qt, kt, vt, pos, pos, aligned=True, **kw)
    assert_close(o, want_o, rtol=RTOL)
    assert_close(o, oracle_o, rtol=FWD_RTOL)
    assert_close(lse, oracle_lse, rtol=FWD_RTOL)
    do = torch.from_numpy(w)
    oracle = oracle_bwd(do, qt, kt, vt, oracle_o, oracle_lse, pos, pos,
                        **kw)
    before = _rows_total()
    _, got = _port_grads(q, k, v, w, pos_np, aligned=True, **kw)
    after = _rows_total()
    for g_, exp, orc in zip(got, want, oracle):
        assert torch.isfinite(g_).all()
        assert_close(g_, exp, rtol=RTOL)
        assert_close(g_, orc, rtol=RTOL)
    moved = {key: after[key] - before[key] for key in after}
    assert moved[("computed", "fwd")] == moved[("computed", "bwd")]
    assert moved[("skipped", "fwd")] == moved[("skipped", "bwd")]
    n_chunks = -(-q.shape[1] // kw["kc"])
    assert moved[("computed", "fwd")] + moved[("skipped", "fwd")] == \
        n_chunks * q.shape[1]
    if kw["causal"] or kw["window"]:
        assert moved[("skipped", "fwd")] > 0


@pytest.mark.parametrize("name", ["causal-gqa", "window-narrower-than-kc",
                                  "window-crossing-chunk-edges",
                                  "equal-offset", "bidirectional-window"])
def test_all_chunks_loop_adds_exact_zero_to_skipped_rows(rs, name):
    """Why the skipping is exact: in the all-chunks loop, a row outside a
    chunk's range that has seen a key keeps its running max, sum and
    accumulator bit for bit through the chunk, and in its backward such a
    row's probabilities are exactly 0.  A row that has seen no key yet is
    overwritten at its first key (a correction of exactly 0)."""
    (q, k, v, _), pos_np, kw = _case(rs, name)
    pos = torch.from_numpy(pos_np)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    sq, kc = q.shape[1], kw["kc"]
    rows = tattn._chunk_rows(sq, sq, kc, True, causal=kw["causal"],
                             window=kw["window"])
    _, lse = oracle_fwd(qt, kt, vt, pos, pos, **kw)
    b, _, g_kv, g, d = q.shape
    m = torch.full((b, g_kv, g, sq), tattn.NEG_INF)
    l, acc = torch.zeros((b, g_kv, g, sq)), torch.zeros((b, g_kv, g, sq, d))
    seen = torch.zeros(sq, dtype=torch.bool)
    for c0, n, r0, r1, _ in rows:
        s = oracle_scores(qt.float(), kt[:, c0:c0 + n], pos,
                          pos[c0:c0 + n], scale=kw["scale"],
                          softcap=kw["softcap"], causal=kw["causal"],
                          window=kw["window"])
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + torch.sum(p, dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vt[:, c0:c0 + n])
        out = torch.ones(sq, dtype=torch.bool)
        out[r0:max(r0, r1)] = False
        kept = out & seen
        assert torch.equal(m_new[..., kept], m[..., kept])
        assert torch.equal(l_new[..., kept], l[..., kept])
        assert torch.equal(acc_new[..., kept, :], acc[..., kept, :])
        assert torch.count_nonzero(
            torch.exp(s - lse[..., None])[..., out, :]) == 0
        fresh = ~seen
        fresh[out] = False               # first keys: corrections of 0
        assert torch.count_nonzero(corr[..., fresh]) == 0
        seen[r0:max(r0, r1)] = True
        m, l, acc = m_new, l_new, acc_new


def test_unknown_positions_take_every_chunk(rs):
    """Without host-known positions (not ``aligned``: a prefill into a
    cache at a device index, or positions a caller passes) every chunk
    takes every row: the all-chunks loop's numbers, none skipped."""
    (q, k, v, w), pos_np, kw = _case(rs, "window-crossing-chunk-edges")
    pos = torch.from_numpy(pos_np)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    assert tattn._chunk_rows(64, 64, 16, False, causal=True, window=20) == \
        [(c0, 16, 0, 64, ((0, 64),)) for c0 in range(0, 64, 16)]
    want_o, want_lse = oracle_fwd(qt, kt, vt, pos, pos, **kw)
    before = _rows_total()
    o, lse = tattn._flash_fwd_impl(qt, kt, vt, pos, pos, **kw)
    after = _rows_total()
    assert after[("skipped", "fwd")] == before[("skipped", "fwd")]
    assert after[("computed", "fwd")] - before[("computed", "fwd")] == 4 * 64
    assert_close(o, want_o, rtol=FWD_RTOL)
    assert_close(lse, want_lse, rtol=FWD_RTOL)


@pytest.mark.parametrize("sq,kc,window,share", [
    (8192, 512, None, 0.46875),       # the training cell: 136 of 256 blocks
    # window 1024: a chunk reaches 1535 rows, the last two 1024 and 512
    (4096, 512, 1024, 1 - (6 * 1535 + 1024 + 512) / (8 * 4096)),
])
def test_skipped_rows_counter_closed_form(sq, kc, window, share):
    """The counter's skipped share against the closed form, in the
    forward and the backward of one call (one head, D 4)."""
    rows = tattn._chunk_rows(sq, sq, kc, True, causal=True, window=window)
    w = sq if window is None else window
    want = sum(min(sq, c0 + kc + w - 1) - c0 for c0 in range(0, sq, kc))
    assert sum(r1 - r0 for _, _, r0, r1, _ in rows) == want
    assert 1 - want / (sq * (sq // kc)) == share
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, sq, 1, *d, generator=gen)
               for d in ((1, 4), (4,), (4,)))
    q.requires_grad_(True)
    pos = torch.arange(sq)
    before = _rows_total()
    o = tattn._sdpa_flash(q, k, v, scale=0.5, softcap=None, q_pos=pos,
                          k_pos=pos, causal=True, window=window, kc=kc,
                          aligned=True)
    o.sum().backward()
    after = _rows_total()
    for dr in ("fwd", "bwd"):
        skipped = after[("skipped", dr)] - before[("skipped", dr)]
        computed = after[("computed", dr)] - before[("computed", dr)]
        assert computed == want
        assert skipped / (skipped + computed) == share

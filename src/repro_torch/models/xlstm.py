"""xLSTM blocks: mLSTM (matrix memory, parallelizable) + sLSTM (scalar
memory, sequential) — Beck et al. 2024 (arXiv:2405.04517).

mLSTM recurrence (per head):
    C_t = f_t C_{t-1} + i_t (k_t v_t^T)      C: [d_k, d_v] matrix memory
    n_t = f_t n_{t-1} + i_t k_t
    y_t = (q_t^T C_t) / max(|q_t^T n_t|, 1)

Counterpart of the reference package's ``repro/models/xlstm.py``.
Training and prefill use the exact chunkwise form (intra-chunk quadratic
with decay masks, inter-chunk carried fp32 state); decode is the O(1)
recurrence.  The pairwise decay exponent is masked to 0 above the diagonal
before ``exp``: there it is positive and can overflow, and the backward of
a masked ``inf`` would give NaN gradients.  A ragged last chunk is shorter
(the reference pads it with i = 0, f = 1, which changes nothing).

sLSTM: per-head scalar recurrence with an exp input gate, a normalizer and
a max stabilizer; sequential, so the forward loops over time on the device
(no host synchronization inside the loop).

The projections ``wq``/``wk``/``wv``/``wo`` (mLSTM) and ``wz``/``wo_gate``/
``wout`` (sLSTM) carry ``abft``; the gate projections ``wi`` and ``wf`` run
unprotected in fp32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (linear_apply, linear_init,
                                       rmsnorm_apply, rmsnorm_init)

__all__ = ["XLSTMSpec", "mlstm_init", "mlstm_apply", "mlstm_decode_step",
           "mlstm_init_state", "slstm_init", "slstm_apply",
           "slstm_decode_step", "slstm_init_state"]


class XLSTMSpec(NamedTuple):
    d_model: int
    n_heads: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# =========================================================================
# mLSTM
# =========================================================================

def mlstm_init(gen: torch.Generator, s: XLSTMSpec, dtype=torch.float32):
    d = s.d_model
    return {
        "wq": linear_init(gen, d, d, dtype=dtype),
        "wk": linear_init(gen, d, d, dtype=dtype),
        "wv": linear_init(gen, d, d, dtype=dtype),
        "wi": linear_init(gen, d, s.n_heads, dtype=torch.float32),
        "wf": linear_init(gen, d, s.n_heads, dtype=torch.float32),
        "wo": linear_init(gen, d, d, dtype=dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
    }


def _mlstm_qkvif(p, x, s: XLSTMSpec, abft=None):
    b, t, _ = x.shape
    nh, hd = s.n_heads, s.head_dim
    q = linear_apply(p["wq"], x, abft).reshape(b, t, nh, hd)
    k = linear_apply(p["wk"], x, abft).reshape(b, t, nh, hd) * hd ** -0.5
    v = linear_apply(p["wv"], x, abft).reshape(b, t, nh, hd)
    i_gate = torch.sigmoid(linear_apply(p["wi"], x.float()))     # [B,T,H]
    f_gate = torch.sigmoid(linear_apply(p["wf"], x.float()) + 3.0)
    return q, k, v, i_gate, f_gate


def _mlstm_chunk(c_state, n_state, qi, ki, vi, ii, fi):
    """One chunk of the chunkwise form: ``(c_new, n_new, y)``."""
    ln = qi.shape[1]
    lf = torch.log(torch.clamp(fi.float(), min=1e-12))           # [B,L,H]
    cum = torch.cumsum(lf, dim=1)                                # log prod f
    dec_in = torch.exp(cum)                                      # [B,L,H]
    # pairwise decay D_ts = prod_{r=s+1..t} f_r * i_s (t >= s); the
    # exponent is zeroed above the diagonal before exp
    pair = cum[:, :, None, :] - cum[:, None, :, :]               # [B,L,L,H]
    tril = torch.ones((ln, ln), dtype=torch.bool,
                      device=qi.device).tril()[None, :, :, None]
    dmask = torch.where(tril, torch.exp(torch.where(tril, pair, 0.0)), 0.0)
    dmask = dmask * ii[:, None, :, :]                            # apply i_s

    q32, k32, v32 = qi.float(), ki.float(), vi.float()
    # intra-chunk: y_t = sum_{s<=t} D_ts (q_t . k_s) v_s
    scores = torch.einsum("blhd,bmhd->blmh", q32, k32) * dmask
    y_intra = torch.einsum("blmh,bmhd->blhd", scores, v32)
    # inter-chunk: y_t += dec_in_t * q_t^T C_prev
    y_inter = torch.einsum("blhd,bhde->blhe", q32, c_state) * dec_in[..., None]
    num = y_intra + y_inter                                      # [B,L,H,dv]
    # normalizer: n_t = (prod f) n_prev + sum_{s<=t} D_ts k_s
    n_vec = torch.einsum("blmh,bmhd->blhd", dmask, k32)
    n_tot = n_vec + n_state[:, None] * dec_in[..., None]
    den = torch.abs(torch.einsum("blhd,blhd->blh", q32, n_tot))
    y = num / torch.clamp(den, min=1.0)[..., None]

    # carry: C_new = (prod f) C_prev + sum_s (prod_{r>s} f) i_s k_s v_s^T
    tot = torch.exp(cum[:, -1])                                  # [B,H]
    rem = torch.exp(cum[:, -1:, :] - cum)                        # decay s..end
    w_s = rem * ii                                               # [B,L,H]
    c_new = c_state * tot[..., None, None] + torch.einsum(
        "blh,blhd,blhe->bhde", w_s, k32, v32)
    n_new = n_state * tot[..., None] + torch.einsum("blh,blhd->bhd", w_s, k32)
    return c_new, n_new, y


def mlstm_apply(p, x, s: XLSTMSpec, *, chunk: int = 128, abft=None,
                return_state: bool = False, state=None):
    """Chunkwise-parallel forward. x: [B,S,D] -> [B,S,D] (+ final state).

    ``state`` (``{"c", "n"}``) continues a sequence, as a chunked prefill
    needs; the reference always starts from the zero state."""
    b, t, d = x.shape
    q, k, v, ig, fg = _mlstm_qkvif(p, x, s, abft)
    st = mlstm_init_state(s, b, device=x.device) if state is None else state
    c_state, n_state = st["c"], st["n"]
    ys = []
    for c0 in range(0, t, max(chunk, 1)):
        sl = slice(c0, c0 + chunk)
        c_state, n_state, y = _mlstm_chunk(c_state, n_state, q[:, sl],
                                           k[:, sl], v[:, sl], ig[:, sl],
                                           fg[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(b, t, d)
    y = rmsnorm_apply(p["norm"], y.to(x.dtype))
    out = linear_apply(p["wo"], y, abft)
    if return_state:
        return out, {"c": c_state, "n": n_state}
    return out


def mlstm_init_state(s: XLSTMSpec, batch: int, device=None):
    return {
        "c": torch.zeros((batch, s.n_heads, s.head_dim, s.head_dim),
                         dtype=torch.float32, device=device),
        "n": torch.zeros((batch, s.n_heads, s.head_dim), dtype=torch.float32,
                         device=device),
    }


def mlstm_decode_step(p, x, state, s: XLSTMSpec, abft=None):
    """x: [B,1,D] -> (y: [B,1,D], new_state). Exact recurrence."""
    b = x.shape[0]
    q, k, v, ig, fg = _mlstm_qkvif(p, x, s, abft)
    q32, k32, v32 = (a[:, 0].float() for a in (q, k, v))
    i0, f0 = ig[:, 0], fg[:, 0]                                  # [B,H]
    c = state["c"] * f0[..., None, None] + i0[..., None, None] * (
        k32[..., :, None] * v32[..., None, :])
    n = state["n"] * f0[..., None] + i0[..., None] * k32
    num = torch.einsum("bhd,bhde->bhe", q32, c)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q32, n))
    y = num / torch.clamp(den, min=1.0)[..., None]
    y = y.reshape(b, 1, s.d_model).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y)
    return linear_apply(p["wo"], y, abft), {"c": c, "n": n}


# =========================================================================
# sLSTM
# =========================================================================

def slstm_init(gen: torch.Generator, s: XLSTMSpec, dtype=torch.float32):
    d = s.d_model
    return {
        "wz": linear_init(gen, d, d, dtype=dtype),
        "wi": linear_init(gen, d, s.n_heads, dtype=torch.float32),
        "wf": linear_init(gen, d, s.n_heads, dtype=torch.float32),
        "wo_gate": linear_init(gen, d, d, dtype=dtype),
        "wout": linear_init(gen, d, d, dtype=dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
    }


def slstm_init_state(s: XLSTMSpec, batch: int, device=None):
    return {
        "c": torch.zeros((batch, s.n_heads, s.head_dim), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, s.n_heads), dtype=torch.float32,
                         device=device),
        "m": torch.full((batch, s.n_heads), -1e30, dtype=torch.float32,
                        device=device),
    }


def _slstm_cell(z, i_pre, f_pre, state):
    """One sLSTM step with exp gating + max stabilizer (log-space)."""
    c, n, m = state["c"], state["n"], state["m"]
    logf = -F.softplus(-f_pre)                # log sigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s[..., None] * c + i_s[..., None] * torch.tanh(z)
    n_new = f_s * n + i_s
    h = c_new / torch.clamp(n_new, min=1.0)[..., None]
    return {"c": c_new, "n": n_new, "m": m_new}, h


def slstm_apply(p, x, s: XLSTMSpec, abft=None, return_state: bool = False,
                state=None):
    """Sequential forward (a loop over time). x: [B,S,D] -> [B,S,D].

    ``state`` (``{"c", "n", "m"}``) continues a sequence, as a chunked
    prefill needs; the reference always starts from the initial state."""
    b, t, d = x.shape
    nh, hd = s.n_heads, s.head_dim
    z = linear_apply(p["wz"], x, abft).reshape(b, t, nh, hd).float()
    i_pre = linear_apply(p["wi"], x.float())
    f_pre = linear_apply(p["wf"], x.float())
    o_gate = torch.sigmoid(linear_apply(p["wo_gate"], x, abft).float())
    if state is None:
        state = slstm_init_state(s, b, device=x.device)
    hs = []
    for i in range(t):
        state, h = _slstm_cell(z[:, i], i_pre[:, i], f_pre[:, i], state)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(b, t, d)
    y = (h * o_gate).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y)
    out = linear_apply(p["wout"], y, abft)
    if return_state:
        return out, state
    return out


def slstm_decode_step(p, x, state, s: XLSTMSpec, abft=None):
    b = x.shape[0]
    nh, hd = s.n_heads, s.head_dim
    z = linear_apply(p["wz"], x, abft).reshape(b, 1, nh, hd).float()
    i_pre = linear_apply(p["wi"], x.float())[:, 0]
    f_pre = linear_apply(p["wf"], x.float())[:, 0]
    o_gate = torch.sigmoid(linear_apply(p["wo_gate"], x, abft).float())
    state, h = _slstm_cell(z[:, 0], i_pre, f_pre, state)
    y = (h.reshape(b, 1, s.d_model) * o_gate).to(x.dtype)
    y = rmsnorm_apply(p["norm"], y)
    return linear_apply(p["wout"], y, abft), state

"""Mamba (S6) block for the Jamba hybrid architecture.

Selective SSM:  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t + D x_t
with per-channel diagonal A (log-parameterized), input-dependent (B, C, dt),
a depthwise causal conv front, and a SiLU-gated residual branch.

Counterpart of the reference package's ``repro/models/mamba.py``.  Training
and prefill run a chunked scan: a loop over chunks of ``chunk`` steps
carries the state, and inside a chunk an inclusive scan of the affine maps
``h -> a h + b`` takes log2(chunk) vectorized doubling steps (the
reference's ``associative_scan``), so the materialized state stays
[B, chunk, d_inner, d_state].  A ragged last chunk is shorter (the
reference pads it with identity maps, which changes nothing).  Decode runs
the exact single-step recurrence on a carried state.  ``in_proj`` and
``out_proj`` carry ``abft``; ``x_proj`` runs unprotected, as there.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import linear_apply, linear_init

__all__ = ["MambaSpec", "mamba_init", "mamba_apply", "mamba_decode_step",
           "mamba_init_state"]


class MambaSpec(NamedTuple):
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


def mamba_init(gen: torch.Generator, s: MambaSpec, dtype=torch.float32):
    di, dev = s.d_inner, gen.device
    in_proj = linear_init(gen, s.d_model, 2 * di, dtype=dtype)
    conv_w = (torch.randn((s.d_conv, di), generator=gen, device=dev)
              * s.d_conv ** -0.5).to(dtype)
    x_proj = linear_init(gen, di, 2 * s.d_state + 1, dtype=dtype)
    out_proj = linear_init(gen, di, s.d_model, scale=di ** -0.5, dtype=dtype)
    # dt bias init so softplus(dt) spans ~[1e-3, 1e-1] (mamba default)
    u = torch.rand((di,), generator=gen, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt_bias = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_bias": dt_bias,
        "a_log": torch.log(a).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": out_proj,
    }


def _conv1d_causal(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B,S,di], w: [K,di].  With ``state``
    ([B, K-1, di], the trailing inputs) performs streaming conv."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):]
    return out + b, new_state


def _ssm_params(p, xc, s: MambaSpec):
    """xc: [B,S,di] -> dt [B,S,di], B/C [B,S,ds], A [di,ds]."""
    proj = linear_apply(p["x_proj"], xc)
    b_in = proj[..., :s.d_state].float()
    c_in = proj[..., s.d_state:2 * s.d_state].float()
    dt = F.softplus(proj[..., -1:].float() + p["dt_bias"][None, None])
    a = -torch.exp(p["a_log"])
    return dt, b_in, c_in, a


def _scan_affine(a, b):
    """Inclusive scan of ``h -> a_t h + b_t`` along axis 1 (log-depth
    doubling): returns ``(A_t, B_t)`` with h_t = A_t h_0 + B_t."""
    off, n = 1, a.shape[1]
    while off < n:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def mamba_apply(p, x, s: MambaSpec, *, chunk: int = 256, abft=None,
                return_state: bool = False, state=None):
    """Full-sequence forward. x: [B,S,D] -> y (+ post-sequence state).

    ``state`` (``{"h", "conv"}``, as `mamba_init_state`) continues a
    sequence: a chunked prefill passes the state the previous chunk left.
    The reference always starts from the zero state."""
    bsz, seq, _ = x.shape
    xz = linear_apply(p["in_proj"], x, abft)
    xi, z = xz.chunk(2, dim=-1)
    xc, conv_state = _conv1d_causal(xi, p["conv_w"], p["conv_b"],
                                    None if state is None else state["conv"])
    xc = F.silu(xc)
    dt, b_in, c_in, a = _ssm_params(p, xc, s)

    da = torch.exp(dt[..., None] * a[None, None])                 # [B,S,di,ds]
    dbx = (dt * xc.float())[..., None] * b_in[..., None, :]

    h = torch.zeros((bsz, s.d_inner, s.d_state), dtype=torch.float32,
                    device=x.device) if state is None else state["h"]
    ys = []
    for c0 in range(0, seq, max(chunk, 1)):
        acc_a, acc_b = _scan_affine(da[:, c0:c0 + chunk], dbx[:, c0:c0 + chunk])
        h_all = acc_b + acc_a * h[:, None]                        # [B,L,di,ds]
        h = h_all[:, -1]
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all,
                               c_in[:, c0:c0 + chunk]))
    y = torch.cat(ys, dim=1)
    y = y + p["d_skip"][None, None] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = linear_apply(p["out_proj"], y, abft)
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def mamba_init_state(s: MambaSpec, batch: int, dtype=torch.float32,
                     device=None):
    return {
        "h": torch.zeros((batch, s.d_inner, s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, s.d_inner), dtype=dtype,
                            device=device),
    }


def mamba_decode_step(p, x, state, s: MambaSpec, abft=None):
    """Single-token step. x: [B,1,D] -> (y: [B,1,D], new_state)."""
    xz = linear_apply(p["in_proj"], x, abft)
    xi, z = xz.chunk(2, dim=-1)
    xc, conv_state = _conv1d_causal(xi, p["conv_w"], p["conv_b"],
                                    state["conv"])
    xc = F.silu(xc)
    dt, b_in, c_in, a = _ssm_params(p, xc, s)
    da = torch.exp(dt[:, 0, :, None] * a[None])                   # [B,di,ds]
    dbx = (dt[:, 0] * xc[:, 0].float())[..., None] * b_in[:, 0, None, :]
    h = state["h"] * da + dbx
    y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])
    y = y + p["d_skip"][None] * xc[:, 0].float()
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
    out = linear_apply(p["out_proj"], y, abft)
    return out, {"h": h, "conv": conv_state}

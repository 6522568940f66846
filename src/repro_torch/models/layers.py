"""Shared model building blocks (plain functions on tensors).

Params are plain nested dicts of tensors.  Every `*_init` takes a
`torch.Generator` (whose device places the params) and returns params;
every `*_apply` is side-effect free.  Big projections go through
`core.abft_gemm.abft_matmul` when ABFT protection is enabled; with
``ABFTConfig.backend="cuda"`` (or "auto" on the GPU) they run the fused
dual-checksum CUDA kernel, which also reduces the verification residual in
its epilogue.

Counterpart of the reference package's ``repro/models/layers.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.chaos.faults import register_surface
from repro_torch.core.abft_gemm import ABFTConfig, abft_matmul, encode_weight

# the non-GEMM layer math carries no ABFT checksum columns, but each op has
# a cheap invariant known by construction, checked when `check=True`
register_surface(
    "models.layers/layernorm", owner=__name__, protected=True,
    promise="tolerance",
    detector="second-moment invariant: for y = x * rsqrt(var + eps) the "
             "mean of y^2 equals var/(var+eps) by construction; "
             "rmsnorm_apply(check=True) recomputes the moment from the "
             "normalized output and trips on |residual| > RMSNORM_TOL",
    kinds=("norm_corruption",),
    note="detect-and-recompute: a trip reruns the norm from the (still "
         "clean) input")
register_surface(
    "models.layers/embedding_gather", owner=__name__, protected=True,
    promise="tolerance",
    detector="checksum column appended to the table at apply time "
             "(sum over d_model per row); the gathered rows must satisfy "
             "sum(row) == row_checksum, verified vectorized over tokens",
    kinds=("gather_corruption",),
    note="detect-and-recompute: a trip re-gathers from the table")

# ---------------------------------------------------------------------------
# ABFT-protected linear
# ---------------------------------------------------------------------------


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: Optional[float] = None,
                dtype=torch.float32):
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear_apply(p, x, abft: Optional[ABFTConfig] = None):
    """y = x @ W (+ b), optionally ABFT-protected.

    When abft.active, W is encoded on the fly unless ``p["w_enc"]`` holds a
    pre-encoded copy (the serving engine pre-encodes once).  The
    projection's ``ok`` flag is dropped here, as in the reference.
    """
    w = p["w"]
    if abft is not None and abft.active:
        w_enc = p.get("w_enc")
        if w_enc is None:
            w_enc = encode_weight(w, abft)
        y, _ok = abft_matmul(x, w_enc, abft)
    else:
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


RMSNORM_TOL = 1e-3


def rmsnorm_apply(p, x, eps: float = 1e-6, *, check: bool = False,
                  inject: Optional[float] = None):
    """RMS norm; with ``check=True`` returns ``(y, ok)``.

    The pre-scale output satisfies mean(y_pre^2) == var/(var+eps) by
    construction, so recomputing that moment from y_pre is a free
    integrity invariant over the normalize path.  ``inject`` adds a delta
    to the first y_pre element (drill hook) so the invariant — not the
    injection site — does the detecting.
    """
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y_pre = x32 * torch.rsqrt(var + eps)
    if inject is not None:
        y_pre = y_pre.clone()
        y_pre[(0,) * y_pre.dim()] += inject
    y = (y_pre * p["scale"].float()).to(x.dtype)
    if not check:
        return y
    want = var / (var + eps)
    got = torch.mean(torch.square(y_pre), dim=-1, keepdim=True)
    ok = torch.max(torch.abs(got - want)) <= RMSNORM_TOL
    return y, ok


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding (halves, not interleaved).
    x: [..., S, H, D], positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]           # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             dtype=torch.float32):
    return {
        "gate": linear_init(gen, d_model, d_ff, dtype=dtype),
        "up": linear_init(gen, d_model, d_ff, dtype=dtype),
        "down": linear_init(gen, d_ff, d_model, scale=d_ff ** -0.5,
                            dtype=dtype),
    }


def mlp_apply(p, x, *, activation: str = "silu",
              abft: Optional[ABFTConfig] = None):
    g = linear_apply(p["gate"], x, abft)
    u = linear_apply(p["up"], x, abft)
    act = F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")
    return linear_apply(p["down"], act * u, abft)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32):
    t = torch.randn((vocab, d_model), generator=gen, device=gen.device) * 0.02
    return {"table": t.to(dtype)}


GATHER_TOL = 1e-3


def embed_apply(p, tokens, *, check: bool = False,
                inject: Optional[float] = None):
    """Token embedding gather; with ``check=True`` returns ``(y, ok)``.

    A checksum column (per-row sum over d_model) is appended to the table
    at apply time and gathered alongside the rows; the gathered rows must
    reproduce it, which catches flips in either the gathered activations
    or the table rows feeding them.  ``inject`` perturbs the first gathered
    element (drill hook).
    """
    if not check:
        return p["table"][tokens]
    t32 = p["table"].float()
    aug = torch.cat([t32, torch.sum(t32, dim=-1, keepdim=True)], dim=-1)
    rows = aug[tokens]
    if inject is not None:
        rows[(0,) * rows.dim()] += inject
    y, csum = rows[..., :-1], rows[..., -1]
    resid = torch.abs(torch.sum(y, dim=-1) - csum)
    ok = torch.max(resid) <= GATHER_TOL * (torch.max(torch.abs(csum)) + 1.0)
    return y.to(p["table"].dtype), ok


def unembed_apply(p_head, x, *, softcap: Optional[float] = None,
                  abft: Optional[ABFTConfig] = None):
    logits = linear_apply(p_head, x, abft).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap_fn(x, cap: Optional[float]):
    return cap * torch.tanh(x / cap) if cap else x

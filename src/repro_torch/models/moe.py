"""Mixture-of-Experts FFN with grouped sort-based dispatch.

Counterpart of the reference package's ``repro/models/moe.py``, step for
step, so that capacity drops land on the same tokens: tokens are reshaped
to [G, Tg, D] dispatch groups, and per group

  1. the router's top-k gives (expert_id, weight) per token slot, N = Tg*k
     assignments;
  2. a stable argsort by expert id; rank within an expert = position -
     the expert's start (starts by batched searchsorted);
  3. a copy into the [E, C, D] capacity buffer (overflow drops,
     Switch-style; the reference scatter-adds, the rows are unique);
  4. the expert products [G,E,C,D] x [E,D,F] (plain batched products: the
     reference runs them outside any Pallas kernel);
  5. a gather back by (expert, rank) and the weighted combine of the k
     slots (a permutation back to token order and a sum over the slots:
     no atomics, so the card gives the same bits every call).

Capacity C = ceil(Tg*k/E * capacity_factor), with a dropless floor C = N
while N <= 4096, so decode and short prefills are exact.  A decode step's
buffer therefore spans every expert, and its products read every expert's
weights.  As in the reference, the router runs in fp32 and unprotected,
and ``abft`` is accepted and not used.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import linear_apply, linear_init

__all__ = ["MoESpec", "moe_init", "moe_apply"]


class MoESpec(NamedTuple):
    d_model: int
    d_ff: int            # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    groups: int = 1      # dispatch groups (the reference's DP shard count)
    activation: str = "silu"


def _experts(gen: torch.Generator, e: int, d_in: int, d_out: int, scale,
             dtype):
    """[e, d_in, d_out] normal * scale, drawn one expert at a time so that
    a bf16 init holds at most one expert in fp32."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    if out.device.type == "meta":
        return out                  # shapes only: nothing to draw
    for i in range(e):
        out[i] = (torch.randn((d_in, d_out), generator=gen,
                              device=gen.device) * scale).to(dtype)
    return out


def moe_init(gen: torch.Generator, s: MoESpec, dtype=torch.float32):
    scale_in = s.d_model ** -0.5
    scale_out = s.d_ff ** -0.5
    return {
        "router": linear_init(gen, s.d_model, s.n_experts,
                              dtype=torch.float32),
        "gate": _experts(gen, s.n_experts, s.d_model, s.d_ff, scale_in,
                         dtype),
        "up": _experts(gen, s.n_experts, s.d_model, s.d_ff, scale_in, dtype),
        "down": _experts(gen, s.n_experts, s.d_ff, s.d_model, scale_out,
                         dtype),
    }


def moe_capacity(n: int, s: MoESpec) -> int:
    """Buffer rows per expert for N assignments in a group."""
    if n <= 4096:
        return n  # dropless floor: decode / tiny batches stay exact
    return max(math.ceil(n / s.n_experts * s.capacity_factor), s.top_k)


def moe_apply(p, x, s: MoESpec, abft=None):
    """x: [B, S, D] -> (y: [B, S, D], aux_loss scalar)."""
    b, t, d = x.shape
    n_tok = b * t
    g = s.groups if n_tok % max(s.groups, 1) == 0 else 1
    tg = n_tok // g
    xg = x.reshape(g, tg, d)
    dev = x.device

    logits = linear_apply(p["router"], xg.float())               # [G,Tg,E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, s.top_k, dim=-1)            # [G,Tg,k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e, averaged over
    # the groups
    me = torch.mean(probs, dim=1)                                # [G,E]
    one_hot_tops = F.one_hot(top_e, s.n_experts).float()
    ce = torch.mean(torch.sum(one_hot_tops, dim=2), dim=1) / s.top_k
    aux = s.n_experts * torch.mean(torch.sum(me * ce, dim=-1))

    # ---- grouped sort-based dispatch ----------------------------------
    n = tg * s.top_k
    flat_e = top_e.reshape(g, n)                                 # [G,N]
    flat_w = top_w.reshape(g, n)
    tok_of = (torch.arange(n, device=dev) // s.top_k)[None].expand(g, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    sorted_tok = torch.gather(tok_of, -1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(s.n_experts, device=dev)
        .expand(g, s.n_experts).contiguous(), side="left")       # [G,E]
    rank = (torch.arange(n, device=dev)[None]
            - torch.gather(starts, -1, sorted_e))                # [G,N]

    capacity = moe_capacity(n, s)
    keep = rank < capacity
    # buffer row of each kept assignment (unique); a dropped one goes to a
    # spare last row that is thrown away.  Unique rows make the dispatch a
    # copy and the combine a permutation: deterministic on the card, with
    # the reference's drops and sums.
    n_rows = g * s.n_experts * capacity
    gi = torch.arange(g, device=dev)[:, None]
    row = torch.where(keep, (gi * s.n_experts + sorted_e) * capacity + rank,
                      n_rows)                                    # [G,N]
    src = torch.gather(xg, 1, sorted_tok[..., None].expand(g, n, d))
    buf = torch.zeros((n_rows + 1, d), dtype=x.dtype, device=dev)
    buf.index_copy_(0, row.reshape(-1), src.reshape(-1, d))
    buf = buf[:n_rows].reshape(g, s.n_experts, capacity, d)

    # ---- expert compute -------------------------------------------------
    act = F.silu if s.activation == "silu" else \
        (lambda v: F.gelu(v, approximate="tanh"))
    gate = torch.einsum("gecd,edf->gecf", buf, p["gate"].to(x.dtype))
    up = torch.einsum("gecd,edf->gecf", buf, p["up"].to(x.dtype))
    h = act(gate) * up
    out = torch.einsum("gecf,efd->gecd", h, p["down"].to(x.dtype))

    # ---- combine ----------------------------------------------------------
    w_sorted = torch.gather(flat_w, -1, order)
    gathered = (out.reshape(n_rows, d)[torch.where(keep, row, 0)]
                * keep[..., None].to(x.dtype))                   # [G,N,D]
    y_sorted = gathered * w_sorted[..., None].to(x.dtype)
    # back to (token, slot) order, then the k slots of each token summed
    y_slots = torch.empty_like(y_sorted).scatter(
        1, order[..., None].expand(g, n, d), y_sorted)
    yg = y_slots.reshape(g, tg, s.top_k, d).sum(dim=2)
    return yg.reshape(b, t, d), aux

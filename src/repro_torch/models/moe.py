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

A `DroplessMoESpec` takes the port's own path (`_moe_dropless`,
DeepSeek-V3 §2.1.2): every one of the T*k
assignments reaches its expert, the rows sorted by expert with no capacity
buffer, and the experts' products are checked grouped products
(`core.abft_gemm.abft_matmul_grouped`: kernel #1g on the card) that read
nothing back to the host in the forward; ``n_shared`` shared experts run
as one MLP of width ``n_shared * d_ff`` through `linear_apply`.  Sigmoid
scores pick the top k of ``score + bias`` (``p["bias"]``, a buffer the
train step moves against each expert's load), and the chosen scores,
normalised, times ``routed_scale`` weigh the experts' outputs.  Its aux
loss is DeepSeek-V3's sequence-wise balance loss, unweighted.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.models.layers import (linear_apply, linear_init, mlp_apply,
                                       mlp_init)

__all__ = ["MoESpec", "DroplessMoESpec", "moe_init", "moe_apply"]


class MoESpec(NamedTuple):
    d_model: int
    d_ff: int            # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    groups: int = 1      # dispatch groups (the reference's DP shard count)
    activation: str = "silu"


class DroplessMoESpec(NamedTuple):
    """The port's dropless MoE (`_moe_dropless`): DeepSeek-V3's routing
    and SwiGLU experts."""
    d_model: int
    d_ff: int                     # per-expert hidden dim
    n_experts: int
    top_k: int
    routed_scale: float = 1.0
    n_shared: int = 0             # shared experts, each of width d_ff


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


def moe_init(gen: torch.Generator, s, dtype=torch.float32):
    """A `MoESpec`'s params, or a `DroplessMoESpec`'s: the same experts,
    and its shared experts and selection bias."""
    scale_in = s.d_model ** -0.5
    scale_out = s.d_ff ** -0.5
    p = {
        "router": linear_init(gen, s.d_model, s.n_experts,
                              dtype=torch.float32),
        "gate": _experts(gen, s.n_experts, s.d_model, s.d_ff, scale_in,
                         dtype),
        "up": _experts(gen, s.n_experts, s.d_model, s.d_ff, scale_in, dtype),
        "down": _experts(gen, s.n_experts, s.d_ff, s.d_model, scale_out,
                         dtype),
    }
    if not isinstance(s, DroplessMoESpec):
        return p
    if s.n_shared:
        p["shared"] = mlp_init(gen, s.d_model, s.n_shared * s.d_ff,
                               dtype=dtype)
    # the selection bias: a buffer, not a trainable weight
    p["bias"] = torch.zeros((s.n_experts,), dtype=torch.float32,
                            device=gen.device)
    return p


def moe_capacity(n: int, s: MoESpec) -> int:
    """Buffer rows per expert for N assignments in a group."""
    if n <= 4096:
        return n  # dropless floor: decode / tiny batches stay exact
    return max(math.ceil(n / s.n_experts * s.capacity_factor), s.top_k)


def moe_apply(p, x, s, abft=None, *, layer: Optional[int] = None,
              load: Optional[dict] = None):
    """x: [B, S, D] -> (y: [B, S, D], aux_loss scalar).  A
    `DroplessMoESpec` takes `_moe_dropless` (``layer`` names it in spans
    and counters; ``load``, where given, gets the experts each token chose,
    [B*S, k], at key ``layer``)."""
    if isinstance(s, DroplessMoESpec):
        return _moe_dropless(p, x, s, abft, layer=layer, load=load)
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


def _route(p, xf, s: DroplessMoESpec):
    """(scores [T, E] fp32, chosen experts [T, k], their weights [T, k]):
    sigmoid scores, chosen by ``score + bias``, weighing by the normalised
    chosen scores times ``routed_scale``."""
    scores = torch.sigmoid(linear_apply(p["router"], xf.float()))  # [T, E]
    top_e = torch.topk(scores + p["bias"].float(), s.top_k, dim=-1).indices
    top_w = torch.gather(scores, -1, top_e)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True) * s.routed_scale
    return scores, top_e, top_w


def _seq_balance(scores, top_e, b: int, s: DroplessMoESpec):
    """DeepSeek-V3's sequence-wise balance loss (eqs. 17-20), unweighted:
    per sequence of T tokens, sum_i f_i P_i with f_i = E / (k T) x (tokens
    choosing expert i) and P_i the mean over tokens of the scores
    normalised over experts; the mean over sequences."""
    e = s.n_experts
    sc = scores.reshape(b, -1, e)
    t = sc.shape[1]
    chosen = torch.zeros((b, e), dtype=torch.float32, device=scores.device)
    chosen.scatter_add_(1, top_e.reshape(b, -1),
                        torch.ones((b, t * s.top_k), dtype=torch.float32,
                                   device=scores.device))
    f = chosen * (e / (s.top_k * t))
    prob = torch.mean(sc / torch.sum(sc, dim=-1, keepdim=True), dim=1)
    return torch.mean(torch.sum(f * prob, dim=-1))


def _experts_plain(xs, w, groups):
    """Each expert's rows times its weights, expert by expert over the
    host's copy of the offsets: the unprotected path (ABFT off)."""
    out = torch.zeros((xs.shape[0], w.shape[-1]), dtype=xs.dtype,
                      device=xs.device)
    bounds = groups.host()
    for e in range(w.shape[0]):
        a, c = bounds[e], bounds[e + 1]
        if c > a:
            out[a:c] = torch.matmul(xs[a:c].float(),
                                    w[e].float()).to(xs.dtype)
    return out


def _moe_dropless(p, x, s: DroplessMoESpec, abft, *, layer=None,
                  load=None):
    """Dropless routing and checked grouped expert products: see the module
    docstring.  The forward reads nothing back to the host; the
    tripped-row count and the most rows an expert took are read with the
    offsets once, in the backward (`kernels.ops.ExpertGroups`)."""
    from repro_torch.core.abft_gemm import abft_matmul_grouped
    from repro_torch.kernels.ops import ExpertGroups

    b, t, d = x.shape
    n_tok, k, e = b * t, s.top_k, s.n_experts
    xf = x.reshape(n_tok, d)
    dev = x.device
    with obs.span("moe/route", device=True, layer=layer):
        scores, top_e, top_w = _route(p, xf, s)
        aux = _seq_balance(scores, top_e, b, s)
        flat_e = top_e.reshape(-1)                               # [T*k]
        order = torch.argsort(flat_e, stable=True)
        offsets = torch.searchsorted(
            flat_e[order], torch.arange(e + 1, device=dev))      # [E+1]
        groups = ExpertGroups(offsets)
        xs = torch.index_select(xf, 0, order // k)               # [T*k, D]
        if load is not None:
            load[layer] = top_e
    obs.counter("repro_moe_routed_rows_total",
                "assignments sent to an expert").inc(n_tok * k, layer=layer)
    obs.counter("repro_moe_dropped_rows_total",
                "assignments dropped for capacity").inc(0)
    with obs.span("moe/experts", device=True, layer=layer, rows=n_tok * k,
                  experts=e) as sp:
        attrs = getattr(sp, "attrs", None)
        if attrs is not None:
            groups.read_with(torch.max(offsets[1:] - offsets[:-1]),
                             lambda v: attrs.update(rows_max=v))
        if abft is not None and abft.active:
            gate, _ = abft_matmul_grouped(xs, p["gate"], groups, abft)
            up, _ = abft_matmul_grouped(xs, p["up"], groups, abft)
            y, _ = abft_matmul_grouped(F.silu(gate) * up, p["down"], groups,
                                       abft)
            if groups.trips is not None:
                groups.read_with(groups.trips, _published_trips)
        else:
            h = F.silu(_experts_plain(xs, p["gate"], groups)) \
                * _experts_plain(xs, p["up"], groups)
            y = _experts_plain(h, p["down"], groups)
    out = torch.zeros_like(xf)
    if s.n_shared:
        with obs.span("moe/shared", device=True, layer=layer):
            out = mlp_apply(p["shared"], xf, abft=abft)
    with obs.span("moe/combine", device=True, layer=layer):
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.shape[0], device=dev))
        w_sorted = torch.index_select(top_w.reshape(-1), 0, order)
        yw = torch.index_select(y * w_sorted[:, None].to(y.dtype), 0, inv)
        out = out + yw.reshape(n_tok, k, d).sum(dim=1).to(x.dtype)
    return out.reshape(b, t, d), aux


def _published_trips(n: int) -> None:
    """The grouped products' tripped rows, read with their offsets: each
    a detection and, in correct mode, a repair."""
    if n:
        obs.counter("repro_detections_total",
                    "checksum/invariant trips").inc(
            n, surface="kernels.ops/abft_matmul_grouped")

"""Moonlight-16B-A3B (DeepSeek-V3's block at width 2048) in plain PyTorch,
float32: the forward pass, the training loss, the routing, and one AdamW
step with the selection-bias update.  Gradients come from autograd.

A plain reference of the published model, written from the equations of
DeepSeek-V2 (arXiv:2405.04434, §2.1: latent attention) and DeepSeek-V3
(arXiv:2412.19437, §2.1.2: sigmoid routing with a selection bias, the
sequence-wise balance loss), for comparison with a program that runs the
model: it imports no kernel or module of any such program, and no JAX.
Matrix products run in full float32 (TF32 off for matmul and cuDNN).  No
cache, no batching of experts: each expert is a matmul over the rows it
took, one expert at a time.

The configuration is a dict with the model's published keys
(``hidden_size``, ``kv_lora_rank``, ``n_routed_experts``, ...) plus the
assumed ``aux_loss_alpha`` and ``bias_update_speed``; ``"tf32": True``
rounds both operands of every matrix product to TF32 first (a precision
below the model's float32, for a control that a comparison must fail).
The reference routes for itself.  A token whose k-th and (k+1)-th
selection scores lie within ``TIE_GAP`` is a near tie, which float32
rounding upstream can decide either way: ``"tie_choices"``, a program's
chosen experts ([T, k] for each MoE layer, in order), makes the reference
take the program's choice for such a token, where that choice lies within
its own top k + 1.  The weights are a
tree of tensors: ``embed.table`` [V, D], ``lm_head.w`` [D, V],
``final_norm.scale``, and ``groups``, lists of layers whose ``b0`` holds
``norm1``, ``attn`` (``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``),
``norm2`` and either ``mlp`` (``gate``, ``up``, ``down``) or ``moe``
(``router``, ``gate``/``up``/``down`` stacked [E, ...], ``shared``,
``bias``); each linear holds ``w`` [d_in, d_out] (y = x @ w).

Departures from the published model: RoPE rotates halves of the RoPE dims
(the weights are random, so the published interleaved layout has nothing
to match); the selection bias moves by ``bias_update_speed`` (gamma) a
step and the balance loss weighs ``aux_loss_alpha`` (alpha), both assumed;
the balance loss's P_i averages the scores normalised over the experts,
as the paper's eq. 19 states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["strict_fp32", "layers", "forward", "loss", "adamw_step",
           "bias_step", "TIE_GAP"]

# Selection scores (score + bias, sigmoid scores near 0.5) closer than this
# cannot be told apart by a program whose routing input differs from this
# reference's by float32 rounding carried through the layers before it
# (relative differences about 1e-6): such a token may pick another expert
# there.  Counted, not compared.
TIE_GAP = 1e-5


def strict_fp32() -> None:
    """Full float32 products: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x, cfg):
    """x, or x rounded to TF32 (10 mantissa bits, nearest with ties away
    from zero) where ``cfg["tf32"]``; the gradient passes the rounding as
    it is."""
    if not cfg.get("tf32"):
        return x
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def _mm(a, b, cfg):
    return _round(a, cfg) @ _round(b, cfg)


def _ein(eq, a, b, cfg):
    return torch.einsum(eq, _round(a, cfg), _round(b, cfg))


def layers(params) -> list:
    """The decoder layers in order."""
    return [layer["b0"] for group in params["groups"] for layer in group]


def _rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x, pos, theta):
    """x [B, S, H, d], rotating the two halves of d."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, x, cfg):
    b, s, _ = x.shape
    h = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    pos = torch.arange(s, device=x.device)
    q = _mm(x, p["wq"]["w"], cfg).reshape(b, s, h, dn + dr)
    kv_a = _mm(x, p["wkv_a"]["w"], cfg)
    c = _rms(kv_a[..., :r], p["kv_norm"]["scale"], cfg["rms_norm_eps"])
    k_pe = _rope(kv_a[..., r:].reshape(b, s, 1, dr), pos, cfg["rope_theta"])
    kv = _mm(c, p["wkv_b"]["w"], cfg).reshape(b, s, h, dn + dv)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, cfg["rope_theta"])],
                  dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], dim=-1)
    v = kv[..., dn:]
    scores = _ein("bqhd,bkhd->bhqk", q, k, cfg) * (dn + dr) ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    prob = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = _ein("bhqk,bkhd->bqhd", prob, v, cfg).reshape(b, s, h * dv)
    return _mm(o, p["wo"]["w"], cfg)


def _mlp(p, x, cfg):
    return _mm(F.silu(_mm(x, p["gate"]["w"], cfg)) * _mm(x, p["up"]["w"], cfg),
               p["down"]["w"], cfg)


def _route(p, x, cfg, choice=None):
    """(scores [T, E], chosen [T, k], weights [T, k], near ties) of tokens
    x [T, D]; ``choice``, a program's chosen experts, is taken at near
    ties (module docstring)."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(_mm(x, p["router"]["w"], cfg))
    top = torch.topk(scores + p["bias"], k + 1, dim=-1)
    chosen = top.indices[:, :k]
    tie = top.values[:, k - 1] - top.values[:, k] < TIE_GAP
    if choice is not None:
        within = (choice[:, :, None] == top.indices[:, None, :]).any(-1) \
            .all(-1)
        chosen = torch.where((tie & within)[:, None], choice, chosen)
    w = torch.gather(scores, -1, chosen)
    return scores, chosen, w / w.sum(-1, keepdim=True) \
        * cfg["routed_scaling_factor"], torch.sum(tie)


def _moe(p, x, cfg, choice=None):
    """x [B, S, D] -> (y, balance loss (unweighted), rows each expert
    took [E] followed by the near ties: tokens whose k-th and (k + 1)-th
    selection scores lie within TIE_GAP, the chosen experts [B S, k])."""
    b, s, d = x.shape
    e_n, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    xt = x.reshape(b * s, d)
    scores, chosen, w, ties = _route(p, xt, cfg, choice)
    y = torch.zeros_like(xt)
    for e in range(e_n):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        ye = _mm(F.silu(_mm(xe, p["gate"][e], cfg))
                 * _mm(xe, p["up"][e], cfg), p["down"][e], cfg)
        y = y.index_add(0, tok, ye * w[tok, slot][:, None])
    y = y + _mlp(p["shared"], xt, cfg)
    # the sequence-wise balance loss (DeepSeek-V3 eqs. 17-20)
    sc = scores.reshape(b, s, e_n)
    f = torch.stack([
        torch.bincount(chosen.reshape(b, s * k)[i], minlength=e_n)
        for i in range(b)]).float() * (e_n / (k * s))
    prob = (sc / sc.sum(-1, keepdim=True)).mean(1)
    aux = (f * prob).sum(-1).mean()
    load = torch.bincount(chosen.reshape(-1), minlength=e_n)
    return (y.reshape(b, s, d), aux, torch.cat([load, ties.reshape(1)]),
            chosen)


def _layer(p, x, cfg, choice=None):
    eps = cfg["rms_norm_eps"]
    x = x + _attention(p["attn"], _rms(x, p["norm1"]["scale"], eps), cfg)
    h = _rms(x, p["norm2"]["scale"], eps)
    if "moe" in p:
        y, aux, load, chosen = _moe(p["moe"], h, cfg, choice)
        return x + y, aux, load, chosen
    return (x + _mlp(p["mlp"], h, cfg), torch.zeros((), device=x.device),
            None, None)


def forward(params, tokens, cfg, *, blocks: bool = False, chosen=None):
    """tokens [B, S] -> (logits [B, S, V], balance loss summed over the
    layers, [per MoE layer: the rows each expert took [E] and, last, its
    near ties (TIE_GAP)]); ``chosen``, a list, gets each MoE layer's
    chosen experts [B S, k] in order.  ``blocks`` recomputes
    each layer in the backward (`torch.utils.checkpoint`), so that a long
    sequence's activations are held one layer at a time."""
    strict_fp32()
    x = params["embed"]["table"][tokens]
    aux_total = torch.zeros((), device=x.device)
    loads = []
    choices = iter(cfg.get("tie_choices") or ())
    for p in layers(params):
        choice = next(choices, None) if "moe" in p else None
        if blocks:
            x, aux, load, picked = torch.utils.checkpoint.checkpoint(
                _layer, p, x, cfg, choice, use_reentrant=False)
        else:
            x, aux, load, picked = _layer(p, x, cfg, choice)
        aux_total = aux_total + aux
        if load is not None:
            loads.append(load)
            if chosen is not None:
                chosen.append(picked)
    x = _rms(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    return _mm(x, params["lm_head"]["w"], cfg), aux_total, loads


def loss(params, tokens, labels, cfg, *, blocks: bool = False, chosen=None):
    """(mean next-token NLL + alpha x balance loss, the loads and near ties
    of `forward`); ``chosen`` as in `forward`."""
    logits, aux, loads = forward(params, tokens, cfg, blocks=blocks,
                                 chosen=chosen)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long())
    return nll + cfg["aux_loss_alpha"] * aux, loads


def _lr(count: int, hp: dict) -> float:
    warm = min(count / max(hp["warmup_steps"], 1), 1.0)
    frac = min(max((count - hp["warmup_steps"])
                   / max(hp["total_steps"] - hp["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return hp["lr"] * warm * (hp["min_lr_ratio"]
                              + (1 - hp["min_lr_ratio"]) * cos)


def adamw_step(p, g, m, v, count: int, gnorm: float, hp: dict):
    """One tensor's AdamW update -> (p', m', v'): the gradient clipped by
    the global norm ``gnorm`` to ``grad_clip``, the moments updated, the
    bias-corrected step plus decoupled weight decay at the warmup + cosine
    rate of step ``count`` (counted from 1)."""
    g = g * min(hp["grad_clip"] / (gnorm + 1e-12), 1.0)
    m = hp["b1"] * m + (1 - hp["b1"]) * g
    v = hp["b2"] * v + (1 - hp["b2"]) * g * g
    step = (m / (1 - hp["b1"] ** count)) \
        / (torch.sqrt(v / (1 - hp["b2"] ** count)) + hp["eps"])
    return p - _lr(count, hp) * (step + hp["weight_decay"] * p), m, v


def bias_step(bias, load, cfg):
    """The selection bias after a step whose routing gave ``load`` rows
    an expert: up by gamma where an expert took fewer than the mean, down
    where more."""
    load = load.float()
    return bias + cfg["bias_update_speed"] * torch.sign(load.mean() - load)

"""AdamW from scratch with global-norm clipping and a warmup + cosine
schedule.

The moments (m, v) are fp32 whatever the param dtype; the update runs in
fp32 and is rounded once to the param dtype; the schedule is computed in
float32.  Plain functions on trees of tensors that return new tensors, as
the reference's pure functions do.

Counterpart of the reference package's ``repro/train/optimizer.py``; its
ZeRO-1 spec helper comes with the distribution slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree_leaves(params)[0]
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = _schedule(cfg, count)
    c32 = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=c32.device), c32)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=c32.device), c32)

    def upd(g, m, v, p):
        g32 = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mhat = m_new / b1c
        vhat = v_new / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay * p.float()
        p_new = p.float() - lr * (step + decay)
        return p_new.to(p.dtype), m_new, v_new

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]), tree_leaves(params))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "count": count}, metrics

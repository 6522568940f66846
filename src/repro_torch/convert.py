"""Carry params, and the whole train state, from the reference package's
layout to the port's.

The reference stacks each layout group's layers on axis 0 under
``groups[gi]["b{bi}"]``, and Whisper's encoder layers under ``encoder``;
the port keeps ``groups[gi]`` as a list of per-layer dicts, and
``encoder`` as one such group (``[[layer dicts]]``).  The reference's
tree goes in as numpy arrays (or anything ``np.asarray`` takes), so this
module imports neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["params_from_jax", "state_from_jax", "to_tensor"]


def to_tensor(x, device=None) -> torch.Tensor:
    """One array to a tensor, keeping its dtype (bfloat16 included)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked, n: int, device):
    return [_map(stacked, lambda x, r=r: to_tensor(np.asarray(x)[r], device))
            for r in range(n)]


def params_from_jax(tree, cfg: ModelConfig, device=None):
    """The reference's param tree -> the port's params (same numbers)."""
    out = {k: _map(v, lambda x: to_tensor(x, device))
           for k, v in tree.items() if k not in ("groups", "encoder")}
    if "encoder" in tree:
        out["encoder"] = [_unstack(tree["encoder"], cfg.n_enc_layers,
                                   device)]
    out["groups"] = [_unstack(tree["groups"][gi], repeats, device)
                     for gi, (_pattern, repeats) in enumerate(cfg.layout)]
    return out


def state_from_jax(tree, cfg: ModelConfig, device=None):
    """The reference's train state ``{"params", "opt": {"m", "v", "count"},
    "step"}`` -> the port's: params and both moments by the mapping of
    `params_from_jax`, the counters as 0-d tensors.  An ``ef_residual``
    (int8-EF compression) keeps the reference's stacked layout, as the
    port's state holds it."""
    opt = tree["opt"]
    out = {
        "params": params_from_jax(tree["params"], cfg, device),
        "opt": {"m": params_from_jax(opt["m"], cfg, device),
                "v": params_from_jax(opt["v"], cfg, device),
                "count": to_tensor(opt["count"], device)},
        "step": to_tensor(tree["step"], device),
    }
    if "ef_residual" in tree:
        out["ef_residual"] = _map_lists(tree["ef_residual"],
                                        lambda x: to_tensor(x, device))
    return out


def _map_lists(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_lists(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_lists(v, fn) for v in tree)
    return fn(tree)

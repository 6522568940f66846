"""Step options, the train state and the train step on one device.

``build_train_step`` assembles microbatched gradient accumulation (fp32
accumulators), per-block activation checkpointing (``remat``), ABFT
protection of every projection (``abft_mode``: on a CUDA tensor the
projections run kernel #1, differentiated through ``kernels.ops._FusedMM``),
global-norm clipping and AdamW.  The step is eager PyTorch: it returns
``step_fn(state, batch) -> (new_state, metrics)`` with the reference's
state ``{"params", "opt": {"m", "v", "count"}, "step"}`` and metrics
``{"grad_norm", "lr", "loss"}``.

Counterpart of the reference package's ``repro/train/step.py``.  Its
multi-device options (deferred and ABFT-protected gradient reductions, SDC
injection, gradient compression, ZeRO and FSDP) and the construction
invariants raise ``NotImplementedError`` naming the slice that brings
them; its prefill and serve steps have no counterpart, since the serving
engine calls the model directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.abft_gemm import ABFTConfig
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["StepOptions", "build_train_step", "init_state"]

_DIST = "the distribution + elastic-FT slice of ROADMAP.md"


@dataclasses.dataclass(frozen=True)
class StepOptions:
    microbatches: int = 1
    remat: bool = True
    abft_mode: str = "off"         # off | checksum | verify | correct
    abft_f: int = 2
    # matmul-ABFT backend: "cuda" routes the protected projections through
    # the fused dual-checksum kernel (kernels.ops), "ref" keeps the plain
    # PyTorch path, "auto" takes the kernel on CUDA tensors.
    abft_backend: str = "auto"
    # operand dtype for the ABFT-protected projections: "fp32" | "bf16" |
    # "int8".  Narrows only the GEMM A/B stream; checksums stay fp32 with
    # dtype-aware detection eps (core.abft_gemm).
    kernel_dtype: str = "fp32"
    aux_weight: float = 0.01
    # not ported yet: each raises NotImplementedError in build_train_step
    grad_compression: str = "none"
    defer_grad_reduce: bool = False
    zero1: bool = False
    zero2: bool = False
    fsdp: bool = False
    abft_reduce: str = "off"
    sdc_inject: Optional[Tuple] = None
    invariant_checks: bool = False

    @property
    def abft(self) -> Optional[ABFTConfig]:
        if self.abft_mode == "off":
            return None
        return ABFTConfig(mode=self.abft_mode, f=self.abft_f,
                          backend=self.abft_backend,
                          in_dtype=self.kernel_dtype)


def _check_ported(opts: StepOptions) -> None:
    later = {
        "grad_compression": (opts.grad_compression != "none", _DIST),
        "defer_grad_reduce": (opts.defer_grad_reduce, _DIST),
        "zero1": (opts.zero1, _DIST),
        "zero2": (opts.zero2, _DIST),
        "fsdp": (opts.fsdp, _DIST),
        "abft_reduce": (opts.abft_reduce != "off", _DIST),
        "sdc_inject": (opts.sdc_inject is not None, _DIST),
        "invariant_checks": (opts.invariant_checks,
                             "the protected-LM slice of ROADMAP.md"),
    }
    for name, (on, where) in later.items():
        if on:
            raise NotImplementedError(f"StepOptions.{name} is not ported "
                                      f"yet: it comes with {where}")


def init_state(gen: torch.Generator, cfg: ModelConfig):
    """The train state, params drawn from ``gen`` on ``gen.device``."""
    params = tf.init_params(gen, cfg)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


def _as_tokens(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.int64)


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     adamw: AdamWConfig = AdamWConfig(),
                     opts: StepOptions = StepOptions()):
    """Returns ``step_fn(state, batch) -> (new_state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` [global_batch, seq_len] (numpy arrays
    or tensors)."""
    _check_ported(opts)
    m = max(opts.microbatches, 1)
    if shape.global_batch % m:
        raise ValueError(f"{m} microbatches do not divide the global batch "
                         f"{shape.global_batch}")
    abft = opts.abft

    def value_and_grad(params, tokens, labels):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = tf.loss_fn(tree_unflatten(params, live), tokens, labels, cfg,
                          abft=abft, remat=opts.remat,
                          aux_weight=opts.aux_weight)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(params, list(grads))

    def accumulate(params, tokens, labels):
        """Microbatch loop with fp32 gradient accumulators (one microbatch:
        the grads in the params' dtype, as the reference)."""
        if m == 1:
            return value_and_grad(params, tokens, labels)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for tok, lab in zip(tokens.chunk(m), labels.chunk(m)):
            loss, g = value_and_grad(params, tok, lab)
            loss_acc = loss_acc + loss
            g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
        return loss_acc / m, tree_map(lambda g: g / m, g_acc)

    def step_fn(state, batch):
        params = state["params"]
        dev = tree_leaves(params)[0].device
        tokens = _as_tokens(batch["tokens"], dev)
        labels = _as_tokens(batch["labels"], dev)
        loss, grads = accumulate(params, tokens, labels)
        new_params, new_opt, metrics = adamw_update(grads, state["opt"],
                                                    params, adamw)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss)

    return step_fn

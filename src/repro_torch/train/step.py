"""Step options, the train state and the train step on one device.

``build_train_step`` assembles microbatched gradient accumulation (fp32
accumulators), per-block activation checkpointing (``remat``), ABFT
protection of every projection (``abft_mode``: on a CUDA tensor the
projections run kernel #1, differentiated through ``kernels.ops._FusedMM``),
global-norm clipping and AdamW.  The step is eager PyTorch: it returns
``step_fn(state, batch) -> (new_state, metrics)`` with the reference's
state ``{"params", "opt": {"m", "v", "count"}, "step"}`` and metrics
``{"grad_norm", "lr", "loss"}``.

The deferred gradient reduction runs at DP extent 1, as the reference's
does on one device: ``defer_grad_reduce`` reduces once after the
microbatches, and ``abft_reduce`` sends the gradients through the
checksum-verified reduction (`dist.collectives.abft_psum_tree`) in the
reference's leaf layout (each layout group's layers stacked into one
leaf), with ``sdc_inject`` corrupting it mid-reduction; the result is
``metrics["abft_ok"]``.

Counterpart of the reference package's ``repro/train/step.py``.  Gradient
compression, ZeRO and FSDP raise ``NotImplementedError`` naming port
slice 13, the construction invariants naming port slice 12; its prefill and
serve steps have no counterpart, since the serving engine calls the model
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.abft_gemm import ABFTConfig
from repro_torch.dist.collectives import abft_psum_tree
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update)
from repro_torch.tree import (stack_layers, tree_leaves, tree_map,
                              tree_unflatten, unstack_layers)

__all__ = ["StepOptions", "build_train_step", "init_state"]

_DIST = "port slice 13 (multi-process distribution) of ROADMAP.md"


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
    # reduce the gradients once, after the microbatches (DP extent 1)
    defer_grad_reduce: bool = False
    # checksum-protect that reduction (dist.collectives.abft_psum_tree):
    # "verify" detects (metrics["abft_ok"]), "correct" also repairs a
    # single corrupted element; needs defer_grad_reduce
    abft_reduce: str = "off"       # off | verify | correct
    # drill hook: (dp_shard, delta), or a tuple of such pairs (event j
    # lands in the j-th protected reduction), corrupts the reduction
    sdc_inject: Optional[Tuple] = None
    # not ported yet: each raises NotImplementedError in build_train_step
    grad_compression: str = "none"
    zero1: bool = False
    zero2: bool = False
    fsdp: bool = False
    invariant_checks: bool = False

    @property
    def abft(self) -> Optional[ABFTConfig]:
        if self.abft_mode == "off":
            return None
        return ABFTConfig(mode=self.abft_mode, f=self.abft_f,
                          backend=self.abft_backend,
                          in_dtype=self.kernel_dtype)


def _check_options(opts: StepOptions) -> None:
    """The reference's option checks, then the options not ported yet."""
    if opts.abft_reduce != "off" and (
            not opts.defer_grad_reduce or opts.zero2
            or opts.grad_compression != "none"):
        raise ValueError(
            "abft_reduce protects the deferred DP all-reduce: it requires "
            "defer_grad_reduce=True and is incompatible with zero2 / "
            f"grad_compression (got {opts})")
    if opts.sdc_inject is not None and opts.abft_reduce == "off":
        raise ValueError("sdc_inject corrupts the protected reduction — "
                         "set abft_reduce to 'verify' or 'correct'")
    if opts.invariant_checks and opts.defer_grad_reduce:
        raise ValueError("invariant_checks rides the standard grad path; "
                         "the deferred manual-DP region does not thread "
                         "the invariant flags")
    if opts.abft_reduce not in ("off", "verify", "correct"):
        raise ValueError(f"unknown abft_reduce {opts.abft_reduce!r}")
    later = {
        "grad_compression": (opts.grad_compression != "none", _DIST),
        "zero1": (opts.zero1, _DIST),
        "zero2": (opts.zero2, _DIST),
        "fsdp": (opts.fsdp, _DIST),
        "invariant_checks": (opts.invariant_checks,
                             "port slice 12 (the protected LM) of "
                             "ROADMAP.md"),
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
    _check_options(opts)
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
        reduce_ok = None
        if opts.abft_reduce != "off":
            # the reference's leaves: one stacked [R, ...] leaf per layout
            # group's param, so that event j of sdc_inject lands in the
            # same reduction, on a grid of the same size, as there
            stacked = stack_layers(grads)
            reduced, reduce_ok = abft_psum_tree(
                tree_map(lambda g: g[None], stacked), 0, 1,
                mode=opts.abft_reduce, inject=opts.sdc_inject)
            grads = unstack_layers(reduced, grads)
        new_params, new_opt, metrics = adamw_update(grads, state["opt"],
                                                    params, adamw)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = dict(metrics, loss=loss)
        if reduce_ok is not None:
            metrics["abft_ok"] = reduce_ok.float()
        return new_state, metrics

    return step_fn

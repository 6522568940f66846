"""Step options, the train state and the train step on one device.

``build_train_step`` assembles microbatched gradient accumulation (fp32
accumulators), per-block activation checkpointing (``remat``), ABFT
protection of every projection (``abft_mode``: on a CUDA tensor the
projections run kernel #1, differentiated through ``kernels.ops._FusedMM``),
global-norm clipping and AdamW.  The step is eager PyTorch: it returns
``step_fn(state, batch) -> (new_state, metrics)`` with the reference's
state ``{"params", "opt": {"m", "v", "count"}, "step"}`` and metrics
``{"grad_norm", "lr", "loss"}``.  A batch may carry ``frames`` (Whisper's
encoder input) and ``img_emb`` (the vision stub's) beside ``tokens`` and
``labels``; the MoE load-balance loss enters the loss with weight
``aux_weight``.  ``invariant_checks`` runs the embedding-gather and rmsnorm
construction checks inside the loss and reports their AND as
``metrics["inv_ok"]`` (1.0 when every check held, over every microbatch).

With a logical mesh (``mesh=``, `dist.sharding.Mesh`) the step runs at
its DP extent: the global batch splits ``split`` ways, ``split`` being the
extent of ``batch_specs(mesh, global_batch)[0]``, as in the reference's
`ft.runtime` generations.  Each DP shard runs its own microbatch loop on
its local batch and writes its gradients into one slice of a stacked
``[split, ...]`` buffer in the reference's leaf layout (each layout
group's layers stacked into one leaf); the loss is the mean of the shard
losses and the gradients are reduced over the stacked axis: a plain mean,
or with ``abft_reduce`` the checksum-verified reduction
(`dist.collectives.abft_psum_tree`), where ``sdc_inject=(j, delta)`` hits
shard j's contribution.  At split 1 the step is the one-device step, bit
for bit: ``defer_grad_reduce`` reduces once after the microbatches, and
``abft_reduce`` runs the verified reduction over one shard.

``zero1`` (on by default, as in the reference) shards the optimizer state
over the DP axes; on the logical mesh that is a layout the specs record
(`state_specs`): the device holds each moment whole.  ``remat_policy``
selects what the block checkpoints recompute (``"nothing"`` saved, or the
``"dots"``), never the result.

Counterpart of the reference package's ``repro/train/step.py``.  Gradient
compression, ZeRO-2 and FSDP raise ``NotImplementedError`` naming port
slice 14; its prefill and serve steps have no counterpart, since the
serving engine calls the model directly.
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
from repro_torch.tree import (stack_layers, stacked_leaves_with_path,
                              tree_get, tree_leaves, tree_leaves_with_path,
                              tree_map, tree_unflatten, unstack_layers)

__all__ = ["StepOptions", "build_train_step", "init_state", "state_specs",
           "state_shapes"]

_DIST = "port slice 14 (tuning and cost accounting) of ROADMAP.md"


@dataclasses.dataclass(frozen=True)
class StepOptions:
    microbatches: int = 1
    remat: bool = True
    # ZeRO-1: the optimizer state sharded over DP (a layout the specs
    # record on the logical mesh; the identity at DP extent 1)
    zero1: bool = True
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
    # reduce the gradients once, after the microbatches
    defer_grad_reduce: bool = False
    # checksum-protect that reduction (dist.collectives.abft_psum_tree):
    # "verify" detects (metrics["abft_ok"]), "correct" also repairs a
    # single corrupted element; needs defer_grad_reduce
    abft_reduce: str = "off"       # off | verify | correct
    # drill hook: (dp_shard, delta), or a tuple of such pairs (event j
    # lands in the j-th protected reduction), corrupts the reduction
    sdc_inject: Optional[Tuple] = None
    # remat policy for the block checkpoints: "nothing" saves nothing (min
    # memory, max recompute), "dots" saves the unbatched matmuls' outputs
    remat_policy: str = "nothing"
    # not ported yet: each raises NotImplementedError in build_train_step
    grad_compression: str = "none"
    zero2: bool = False
    fsdp: bool = False
    # the construction invariants inside the loss (metrics["inv_ok"])
    invariant_checks: bool = False

    @property
    def remat_arg(self):
        if not self.remat:
            return False
        return "dots" if self.remat_policy == "dots" else True

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
    if opts.remat_policy not in ("nothing", "dots"):
        raise ValueError(f"unknown remat_policy {opts.remat_policy!r}")
    later = {
        "grad_compression": (opts.grad_compression != "none", _DIST),
        "zero2": (opts.zero2, _DIST),
        "fsdp": (opts.fsdp, _DIST),
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


def state_shapes(cfg: ModelConfig):
    """The train state's tree with a meta tensor (shape and type, no
    storage) at every leaf: the port's counterpart of the reference's
    ``jax.eval_shape`` of `init_state`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_state(torch.Generator(), cfg)
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), fake)


def state_specs(state_shapes, mesh, opts: StepOptions, cfg=None):
    """Mesh-agnostic PartitionSpec tree for a whole train state, in the
    reference's stacked leaf layout.

    Param rules come from `dist.sharding`, optimizer-state rules from the
    optimizer itself (`adamw_opt_specs`), so `ckpt.elastic` re-places
    params AND ZeRO-1 opt state onto a survivor mesh with one call."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train.optimizer import adamw_opt_specs

    params = shd.stacked_shapes(state_shapes["params"])
    pspecs = shd.infer_param_specs(params, mesh, cfg)
    if opts.fsdp:
        # params carry the DP sharding; the opt state shares it
        pspecs = tree_map(lambda sp, sh: shd.zero1_spec(
            sp, tuple(sh.shape), mesh), pspecs, params)
        opt = adamw_opt_specs(pspecs)
    else:
        opt = adamw_opt_specs(pspecs, params, mesh, zero1=opts.zero1)
    return {"params": pspecs, "opt": opt, "step": shd.P()}


def _as_tokens(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device=device, dtype=torch.int64)


def _moe_cfg(cfg: ModelConfig, groups: int) -> ModelConfig:
    """MoE dispatch groups set to ``groups``: the groups of ONE DP shard's
    local batch.  The reference sorts device-locally: its standard path
    cuts the global batch into DP-extent contiguous groups (one shard's
    rows each, so ``ndp / split`` a shard here), its deferred region one
    group a shard."""
    if not cfg.n_experts or cfg.moe_groups == groups:
        return cfg
    return cfg.scaled(moe_groups=groups)


class _StackedGrads:
    """The stacked ``[split, ...]`` gradient buffer in the reference's leaf
    layout, allocated once a step: shard j's gradients are copied into
    slice j as they come, so the per-layer gradients of one shard are the
    only other copy alive."""

    def __init__(self, params, split: int):
        self.parts = []     # [(stacked?, [port paths])] in reference order
        self.bufs = []
        for ref_path, parts in stacked_leaves_with_path(params):
            stacked = parts[0][0] != ref_path
            p0 = parts[0][1]
            shape = ((split, len(parts)) if stacked else (split,)) \
                + tuple(p0.shape)
            dt = torch.float32 if p0.is_floating_point() else p0.dtype
            self.bufs.append(torch.empty(shape, dtype=dt, device=p0.device))
            self.parts.append((stacked, [path for path, _ in parts]))

    def put(self, j: int, grads) -> None:
        for buf, (stacked, paths) in zip(self.bufs, self.parts):
            if stacked:
                for r, path in enumerate(paths):
                    buf[j, r].copy_(tree_get(grads, path))
            else:
                buf[j].copy_(tree_get(grads, paths[0]))

    def unstack(self, reduced, params):
        """The reduced stacked leaves (one per buffer) back in ``params``'
        per-layer structure, as views."""
        by_path = {}
        for y, (stacked, paths) in zip(reduced, self.parts):
            for r, path in enumerate(paths):
                by_path[path] = y[r] if stacked else y
        return tree_unflatten(params, [
            by_path[path].to(p.dtype)
            for path, p in tree_leaves_with_path(params)])


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     adamw: AdamWConfig = AdamWConfig(),
                     opts: StepOptions = StepOptions(), mesh=None):
    """Returns ``step_fn(state, batch) -> (new_state, metrics)``; ``batch``
    holds ``tokens`` and ``labels`` [global_batch, seq_len] (numpy arrays
    or tensors).  ``mesh`` (a `dist.sharding.Mesh`, or None for one
    device) sets the DP split of the batch."""
    from repro_torch.dist import sharding as shd

    _check_options(opts)
    m = max(opts.microbatches, 1)
    split, ndp = 1, 1
    if mesh is not None:
        ndp = shd.dp_extent(mesh)
        split = shd._entry_extent(
            mesh, shd.batch_specs(mesh, shape.global_batch)[0])
    if shape.global_batch % (m * split):
        raise ValueError(f"{m} microbatches x {split} DP shards do not "
                         f"divide the global batch {shape.global_batch}")
    cfg = _moe_cfg(cfg, 1 if opts.defer_grad_reduce
                   else max(ndp // split, 1))
    abft = opts.abft

    inv_on = opts.invariant_checks

    def value_and_grad(params, tokens, labels, extra):
        """``(loss, grads, inv_ok)``; ``inv_ok`` is None with the checks
        off."""
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        out = tf.loss_fn(tree_unflatten(params, live), tokens, labels, cfg,
                         abft=abft, remat=opts.remat_arg,
                         aux_weight=opts.aux_weight, invariants=inv_on,
                         **extra)
        loss, ok = out if inv_on else (out, None)
        grads = torch.autograd.grad(loss, live)
        return loss.detach(), tree_unflatten(params, list(grads)), ok

    def accumulate(params, tokens, labels, extra):
        """Microbatch loop with fp32 gradient accumulators (one microbatch:
        the grads in the params' dtype, as the reference)."""
        if m == 1:
            return value_and_grad(params, tokens, labels, extra)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        ok_acc = torch.ones((), dtype=torch.bool, device=tokens.device)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        parts = [x.chunk(m) for x in (tokens, labels, *extra.values())]
        for i in range(m):
            mb = {k: v[i] for k, v in zip(extra, parts[2:])}
            loss, g, ok = value_and_grad(params, parts[0][i], parts[1][i], mb)
            loss_acc = loss_acc + loss
            if ok is not None:
                ok_acc = ok_acc & ok
            g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
        return (loss_acc / m, tree_map(lambda g: g / m, g_acc),
                ok_acc if inv_on else None)

    def one_shard(params, tokens, labels, extra):
        """The step's gradients at split 1: ``(loss, grads, inv_ok,
        reduce_ok)``, the one-device step bit for bit."""
        loss, grads, inv_ok = accumulate(params, tokens, labels, extra)
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
        return loss, grads, inv_ok, reduce_ok

    def dp_shards(params, tokens, labels, extra):
        """The step's gradients over ``split`` DP shards: each shard's
        microbatch loop on its local batch, its gradients into slice j of
        the stacked buffer, then one reduction over the stacked axis."""
        buf = _StackedGrads(params, split)
        losses, oks = [], []
        local = [x.chunk(split) for x in (tokens, labels, *extra.values())]
        for j in range(split):
            ex = {k: v[j] for k, v in zip(extra, local[2:])}
            loss, grads, ok = accumulate(params, local[0][j], local[1][j],
                                         ex)
            buf.put(j, grads)
            del grads
            losses.append(loss.float())
            if ok is not None:
                oks.append(ok)
        loss = torch.stack(losses).sum() / split
        inv_ok = torch.stack(oks).all() if inv_on else None
        reduce_ok = None
        if opts.abft_reduce != "off":
            reduced, reduce_ok = abft_psum_tree(
                buf.bufs, 0, split, mode=opts.abft_reduce,
                inject=opts.sdc_inject)
        else:
            reduced = [b.sum(0) / split for b in buf.bufs]
        del buf.bufs
        return loss, buf.unstack(reduced, params), inv_ok, reduce_ok

    grads_of = one_shard if split == 1 else dp_shards

    def step_fn(state, batch):
        params = state["params"]
        dev = tree_leaves(params)[0].device
        tokens = _as_tokens(batch["tokens"], dev)
        labels = _as_tokens(batch["labels"], dev)
        extra = {k: torch.as_tensor(batch[k], device=dev)
                 for k in ("frames", "img_emb") if batch.get(k) is not None}
        loss, grads, inv_ok, reduce_ok = grads_of(params, tokens, labels,
                                                  extra)
        new_params, new_opt, metrics = adamw_update(grads, state["opt"],
                                                    params, adamw)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = dict(metrics, loss=loss)
        if reduce_ok is not None:
            metrics["abft_ok"] = reduce_ok.float()
        if inv_ok is not None:
            metrics["inv_ok"] = inv_ok.float()
        return new_state, metrics

    step_fn.split = split
    return step_fn

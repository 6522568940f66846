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
``aux_weight`` (a `DeepSeekV3Config`'s sequence-wise balance loss: its
alpha).  A dropless MoE's selection bias (`models.transformer.is_buffer`)
is no trained weight: it gets no gradient and AdamW leaves it; after the
update it moves by ``cfg.bias_update_rate`` against each expert's load over
the step's whole batch, up where the expert took fewer rows than the mean,
down where more (DeepSeek-V3 §2.1.2).  ``step_fn.moe_chosen`` holds, for
each dropless MoE block's index, the experts its tokens chose in the last
step (the microbatches in order).  ``invariant_checks`` runs the
embedding-gather and rmsnorm construction checks inside the loss and
reports their AND as
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

On the deferred path (``defer_grad_reduce``) two more reductions run, as
in the reference: ``grad_compression="int8_ef"`` reduces the stacked
gradients through `dist.collectives.ef_psum_tree` (its ``psum`` wire, as
the reference's step) with the per-shard error-feedback residual carried
in the state (``state["ef_residual"]``, ``[ndp, *leaf]`` fp32 in the
reference's stacked leaf layout; `init_state` with ``opts`` and ``mesh``
adds it); ``zero2`` reduce-scatters each leaf along its ZeRO dim (the
same sum as the mean, a layout the step records in ``step_fn.grad_specs``).
``fsdp`` shards the params over DP as well (`state_specs`): on the
logical mesh a layout, so the step computes what it computes without it.

`make_inputs`, `build_prefill_step` and `build_serve_step` are the
reference's serving step builders (the dry run's and the only reference
path that feeds ``frames`` or ``img_emb`` to a prefill or a decode step):
each returns ``(fn, in_shardings, out_shardings)`` over the logical mesh,
the shardings as `dist.sharding.NamedSharding` records.

Counterpart of the reference package's ``repro/train/step.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.abft_gemm import ABFTConfig
from repro_torch.dist.collectives import (abft_psum_tree, ef_psum_tree,
                                          note_collective)
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update_leaves)
from repro_torch.tree import (stack_layers, stacked_leaves_with_path,
                              tree_get, tree_leaves, tree_leaves_with_path,
                              tree_map, tree_unflatten, unstack_layers)

__all__ = ["StepOptions", "build_train_step", "build_serve_step",
           "build_prefill_step", "make_inputs", "init_state", "state_specs",
           "state_shapes"]


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
    # int8 error-feedback compression of the deferred reduction
    # (dist.collectives.ef_psum_tree; the residual rides in the state)
    grad_compression: str = "none"  # none | int8_ef
    # ZeRO-2: reduce-scatter the deferred gradients along each leaf's ZeRO
    # dim (a layout on the logical mesh: the same sum as the mean)
    zero2: bool = False
    # FSDP: the params sharded over DP too (a layout the specs record)
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
    """The reference's option checks, and the values it knows."""
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
    if opts.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"unknown grad_compression "
                         f"{opts.grad_compression!r}: none or int8_ef")
    if opts.grad_compression != "none" and not opts.defer_grad_reduce:
        # the reference's residual enters only its deferred region
        raise ValueError("grad_compression compresses the deferred DP "
                         "reduction: it requires defer_grad_reduce=True")


def _ndp(mesh) -> int:
    from repro_torch.dist import sharding as shd
    return 1 if mesh is None else shd.dp_extent(mesh)


def init_state(gen: torch.Generator, cfg: ModelConfig,
               opts: Optional[StepOptions] = None, mesh=None):
    """The train state, params drawn from ``gen`` on ``gen.device``.  With
    ``opts.grad_compression == "int8_ef"`` it carries the per-DP-shard
    error-feedback residuals, ``ef_residual``: ``[ndp, *leaf]`` fp32 zeros
    for each leaf of the reference's stacked layout (``ndp`` the DP extent
    of ``mesh``, 1 without one)."""
    params = tf.init_params(gen, cfg)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=gen.device)}
    if opts is not None and opts.grad_compression == "int8_ef":
        from repro_torch.dist.sharding import stacked_shapes
        ndp = _ndp(mesh)
        state["ef_residual"] = tree_map(
            lambda p: torch.zeros((ndp,) + tuple(p.shape),
                                  dtype=torch.float32, device=gen.device),
            stacked_shapes(params))
    return state


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device (shape and type, no
    storage), so that `init_state` builds the state's shapes."""

    @property
    def device(self):
        return torch.device("meta")


def state_shapes(cfg: ModelConfig, opts: Optional[StepOptions] = None,
                 mesh=None):
    """The train state's tree with a meta tensor (shape and type, no
    storage) at every leaf: the port's counterpart of the reference's
    ``jax.eval_shape`` of `init_state`."""
    return init_state(_MetaGenerator(), cfg, opts, mesh)


def _zero_layout(pspecs, params, mesh):
    """``pspecs`` with each leaf also sharded over DP along its ZeRO dim
    (`dist.sharding.zero1_spec`): the FSDP params' layout."""
    from repro_torch.dist import sharding as shd
    return tree_map(lambda sp, sh: shd.zero1_spec(sp, tuple(sh.shape), mesh),
                    pspecs, shd.stacked_shapes(params))


def state_specs(state_shapes, mesh, opts: StepOptions, cfg=None):
    """Mesh-agnostic PartitionSpec tree for a whole train state, in the
    reference's stacked leaf layout.

    Param rules come from `dist.sharding`, optimizer-state rules from the
    optimizer itself (`adamw_opt_specs`), so `ckpt.elastic` re-places
    params AND ZeRO-1 opt state onto a survivor mesh with one call.  With
    ``fsdp`` the params (and the moments) carry the DP sharding too; an
    ``ef_residual`` leaf is its param's spec behind a leading DP entry."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train.optimizer import adamw_opt_specs

    params = shd.stacked_shapes(state_shapes["params"])
    pspecs = shd.infer_param_specs(params, mesh, cfg)
    if opts.fsdp:
        # params carry the DP sharding; the opt state shares it
        pspecs = _zero_layout(pspecs, params, mesh)
        opt = adamw_opt_specs(pspecs)
    else:
        opt = adamw_opt_specs(pspecs, params, mesh, zero1=opts.zero1)
    out = {"params": pspecs, "opt": opt, "step": shd.P()}
    if "ef_residual" in state_shapes:
        dp_spec = shd._dp_entry(mesh)
        out["ef_residual"] = tree_map(lambda sp: shd.P(dp_spec, *sp), pspecs)
    return out


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


# fn(trips) on entering and fn(None) on leaving a loop trip that stands
# for ``trips`` identical trips (`launch.hlo_accounting` counts it so)
repeat_hooks: list = []


def _trips(x: torch.Tensor, n: int) -> int:
    """How many of ``n`` identical loop trips one run stands for: all of
    them on the meta device (a dry run: the trips differ only in values,
    which meta tensors do not have), one otherwise."""
    return n if x.device.type == "meta" else 1


@contextlib.contextmanager
def _repeated(trips: int):
    """One loop trip run for ``trips``: the hooks see its bounds, the
    reference's trip-count rule (its accountant multiplies a loop body by
    the loop's known trip count)."""
    if trips == 1 or not repeat_hooks:
        yield
        return
    for hook in repeat_hooks:
        hook(trips)
    try:
        yield
    finally:
        for hook in repeat_hooks:
            hook(None)


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

    def unstack(self, reduced, params, cast: bool = True):
        """The reduced stacked leaves (one per buffer) back in ``params``'
        per-layer structure, as views (cast to the params' dtypes, or kept
        in fp32 with ``cast=False``)."""
        by_path = {}
        for y, (stacked, paths) in zip(reduced, self.parts):
            for r, path in enumerate(paths):
                by_path[path] = y[r] if stacked else y
        return tree_unflatten(params, [
            by_path[path].to(p.dtype) if cast else by_path[path]
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
    compress = opts.defer_grad_reduce and opts.grad_compression == "int8_ef"
    zero2 = opts.defer_grad_reduce and opts.zero2 and not compress
    if compress and split != ndp:
        raise ValueError(f"int8_ef keeps one residual per DP shard: the "
                         f"global batch {shape.global_batch} must split "
                         f"over all {ndp} of them (it splits {split} ways)")
    zdims = grad_specs = None
    if zero2 and mesh is not None:
        # each leaf's ZeRO dim, as the reference's reduce-scatter takes it
        pshapes = shd.stacked_shapes(state_shapes(cfg)["params"])
        pspecs = shd.infer_param_specs(pshapes, mesh, cfg)
        zdims = [shd.zero_dim(sp, tuple(sh.shape), mesh) for sp, sh in
                 zip(tree_leaves(pspecs), tree_leaves(pshapes))]
        dp_entry = shd._dp_entry(mesh)
        grad_specs = tree_unflatten(pspecs, [
            shd.P(*[dp_entry if i == d else None for i in range(sh.dim())])
            for d, sh in zip(zdims, tree_leaves(pshapes))])

    inv_on = opts.invariant_checks
    loads: dict = {}    # MoE block -> rows each expert took, this step
    chosen: dict = {}   # MoE block -> the experts its tokens chose

    def value_and_grad(params, tokens, labels, extra):
        """``(loss, grads, inv_ok)``; ``inv_ok`` is None with the checks
        off.  A buffer's gradient is zero."""
        paths = tree_leaves_with_path(params)
        train = [not tf.is_buffer(path) for path, _ in paths]
        live = [p.detach().requires_grad_(t)
                for (_, p), t in zip(paths, train)]
        load: dict = {}
        out = tf.loss_fn(tree_unflatten(params, live), tokens, labels, cfg,
                         abft=abft, remat=opts.remat_arg,
                         aux_weight=opts.aux_weight, invariants=inv_on,
                         moe_load=load, **extra)
        loss, ok = out if inv_on else (out, None)
        got = iter(torch.autograd.grad(
            loss, [p for p, t in zip(live, train) if t]))
        grads = [next(got) if t else torch.zeros_like(p)
                 for p, t in zip(live, train)]
        for li, c in load.items():
            n = torch.zeros(cfg.n_experts, dtype=torch.int64,
                            device=c.device).scatter_add_(
                0, c.reshape(-1), torch.ones_like(c.reshape(-1)))
            loads[li] = loads[li] + n if li in loads else n
            chosen[li] = torch.cat((chosen[li], c)) if li in chosen else c
        return loss.detach(), tree_unflatten(params, grads), ok

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
        trips = _trips(tokens, m)
        for i in range(0, m, trips):
            mb = {k: v[i] for k, v in zip(extra, parts[2:])}
            with _repeated(trips):
                loss, g, ok = value_and_grad(params, parts[0][i],
                                             parts[1][i], mb)
                loss_acc = loss_acc + loss
                if ok is not None:
                    ok_acc = ok_acc & ok
                g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
        return (loss_acc / m, tree_map(lambda g: g / m, g_acc),
                ok_acc if inv_on else None)

    def one_shard(params, tokens, labels, extra, residual):
        """The step's gradients at split 1: ``(loss, grads, inv_ok,
        reduce_ok, new_residual)``, the one-device step bit for bit."""
        loss, grads, inv_ok = accumulate(params, tokens, labels, extra)
        reduce_ok = new_res = None
        if compress:
            stacked = stack_layers(grads)
            mean, new_res = ef_psum_tree(
                tree_map(lambda g: g[None], stacked), residual, 0, 1)
            grads = unstack_layers(mean, grads)
        elif opts.abft_reduce != "off":
            # the reference's leaves: one stacked [R, ...] leaf per layout
            # group's param, so that event j of sdc_inject lands in the
            # same reduction, on a grid of the same size, as there
            stacked = stack_layers(grads)
            reduced, reduce_ok = abft_psum_tree(
                tree_map(lambda g: g[None], stacked), 0, 1,
                mode=opts.abft_reduce, inject=opts.sdc_inject)
            grads = unstack_layers(reduced, grads)
        return loss, grads, inv_ok, reduce_ok, new_res

    def dp_shards(params, tokens, labels, extra, residual):
        """The step's gradients over ``split`` DP shards: each shard's
        microbatch loop on its local batch, its gradients into slice j of
        the stacked buffer, then one reduction over the stacked axis: the
        int8-EF mean, the protected sum, or the mean (all-reduced, or
        reduce-scattered along each leaf's ZeRO dim with ``zero2``)."""
        buf = _StackedGrads(params, split)
        losses, oks = [], []
        local = [x.chunk(split) for x in (tokens, labels, *extra.values())]
        trips = _trips(tokens, split)
        for j in range(0, split, trips):
            ex = {k: v[j] for k, v in zip(extra, local[2:])}
            with _repeated(trips):
                loss, grads, ok = accumulate(params, local[0][j],
                                             local[1][j], ex)
            for jj in range(j, j + trips):
                buf.put(jj, grads)
            del grads
            losses += [loss.float()] * trips
            if ok is not None:
                oks += [ok] * trips
        loss = torch.stack(losses).sum() / split
        inv_ok = torch.stack(oks).all() if inv_on else None
        reduce_ok = new_res = None
        if compress:
            reduced, new_res = ef_psum_tree(
                buf.bufs, tree_leaves(residual), 0, split)
            new_res = tree_unflatten(residual, new_res)
        elif opts.abft_reduce != "off":
            reduced, reduce_ok = abft_psum_tree(
                buf.bufs, 0, split, mode=opts.abft_reduce,
                inject=opts.sdc_inject)
        else:
            reduced = []
            for i, b in enumerate(buf.bufs):
                y = b.sum(0) / split
                d = zdims[i] if zdims is not None else None
                if d is None:
                    note_collective("all-reduce", y.numel() * 4)
                else:
                    note_collective("reduce-scatter", y.numel() * 4 // ndp)
                reduced.append(y)
        del buf.bufs
        return (loss, buf.unstack(reduced, params, cast=not compress),
                inv_ok, reduce_ok, new_res)

    grads_of = one_shard if split == 1 else dp_shards

    def step_fn(state, batch):
        params = state["params"]
        loads.clear()
        chosen.clear()
        dev = tree_leaves(params)[0].device
        tokens = _as_tokens(batch["tokens"], dev)
        labels = _as_tokens(batch["labels"], dev)
        extra = {k: torch.as_tensor(batch[k], device=dev)
                 for k in ("frames", "img_emb") if batch.get(k) is not None}
        residual = state.get("ef_residual")
        if compress and residual is None:
            raise ValueError("grad_compression='int8_ef' needs the state's "
                             "ef_residual: build it with init_state(..., "
                             "opts, mesh)")
        loss, grads, inv_ok, reduce_ok, new_res = grads_of(
            params, tokens, labels, extra, residual)
        # the gradients held by one list only, which the update empties as
        # it goes: each is freed once its leaf is updated
        grads = tree_leaves(grads)
        new_params, new_opt, metrics = adamw_update_leaves(
            grads, state["opt"], params, adamw)
        if loads:
            new_params = _move_router_bias(new_params, params, loads, cfg)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_res is not None:
            new_state["ef_residual"] = new_res
        elif residual is not None:
            new_state["ef_residual"] = residual
        metrics = dict(metrics, loss=loss)
        if reduce_ok is not None:
            metrics["abft_ok"] = reduce_ok.float()
        if inv_ok is not None:
            metrics["inv_ok"] = inv_ok.float()
        return new_state, metrics

    step_fn.split = split
    step_fn.moe_chosen = chosen
    step_fn.grad_specs = grad_specs    # zero2's gradient layout, or None
    return step_fn


def _move_router_bias(new_params, params, loads: dict, cfg: ModelConfig):
    """``new_params`` with each dropless MoE block's selection bias moved
    from its value in ``params`` by ``cfg.bias_update_rate`` times the sign
    of (mean load - the expert's load), ``loads`` holding each block's rows
    an expert over the step (DeepSeek-V3 §2.1.2); AdamW's value for the
    buffer is dropped."""
    li = -1
    for gi, (pattern, _repeats) in enumerate(cfg.layout):
        for r in range(len(params["groups"][gi])):
            for bi in range(len(pattern)):
                li += 1
                if li not in loads:
                    continue
                key = f"b{bi}"
                old = params["groups"][gi][r][key]["moe"]["bias"]
                load = loads[li].float()
                new_params["groups"][gi][r][key]["moe"]["bias"] = (
                    old + cfg.bias_update_rate
                    * torch.sign(load.mean() - load)).to(old.dtype)
    return new_params


# ---------------------------------------------------------------------------
# inputs and the serving steps
# ---------------------------------------------------------------------------


def make_inputs(cfg: ModelConfig, shape: ShapeConfig, *, structs: bool = True,
                device="cuda"):
    """Stand-ins for every model input of a cell: meta tensors (shape and
    type, no storage; the counterpart of ``jax.ShapeDtypeStruct``), or
    zeros on ``device`` with ``structs=False``."""
    b, s = shape.global_batch, shape.seq_len
    dev = "meta" if structs else device

    def mk(sh, dt):
        return torch.zeros(sh, dtype=dt, device=dev)

    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out = {}
    if shape.kind == "train":
        out["tokens"] = mk((b, s), torch.int32)
        out["labels"] = mk((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = mk((b, s), torch.int32)
    else:  # decode
        out["tokens"] = mk((b, 1), torch.int32)
        out["pos"] = mk((), torch.int32)
    if cfg.n_enc_layers and shape.kind != "decode":
        out["frames"] = mk((b, cfg.n_frames, cfg.d_model), dt)
    if cfg.n_img_tokens:
        out["img_emb"] = mk((b, cfg.n_img_tokens, cfg.d_model), dt)
    return out


def _input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """PartitionSpec per input of `make_inputs`: the batch dim over the
    DP axes that divide it, ``pos`` replicated."""
    from repro_torch.dist import sharding as shd
    bspec = shd.batch_specs(mesh, shape.global_batch)
    specs = {}
    for k, v in make_inputs(cfg, shape).items():
        specs[k] = shd.P() if k == "pos" else \
            shd.P(*(list(bspec) + [None] * (v.dim() - 1)))
    return specs


def _serve_shardings(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     opts: StepOptions):
    """(in_shardings, out_shardings) of a prefill or serve step: params
    (ZeRO-sharded too with ``fsdp``), inputs and the cache in, the last
    position's logits and the cache out."""
    from repro_torch.dist import sharding as shd
    pshapes = shd.stacked_shapes(state_shapes(cfg)["params"])
    cache_shapes = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
    pspecs = shd.infer_param_specs(pshapes, mesh, cfg)
    if opts.fsdp:
        pspecs = _zero_layout(pspecs, pshapes, mesh)
    cspecs = shd.map_with_path(
        shd.cache_specs(mesh, shape.global_batch, cfg), cache_shapes)
    cache_sh = shd.to_shardings(cspecs, mesh)
    in_sh = (shd.to_shardings(pspecs, mesh),
             shd.to_shardings(_input_specs(cfg, shape, mesh), mesh), cache_sh)
    out_sh = (shd.NamedSharding(mesh, shd.P(
        *shd.batch_specs(mesh, shape.global_batch), None)), cache_sh)
    return in_sh, out_sh


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                       opts: StepOptions = StepOptions()):
    """``(prefill_fn, in_shardings, out_shardings)``: ``prefill_fn(params,
    batch, cache) -> (logits [B, V] at the last position, cache)`` runs the
    forward over ``batch["tokens"]`` (and ``frames`` / ``img_emb`` where
    the config has them) and writes the prompt into ``cache``
    (`models.transformer.init_cache` of the cell's batch and seq_len), the
    protected projections as ``opts.abft`` asks.  ``mesh`` None is the
    1 x 1 mesh on the CUDA device."""
    from repro_torch.dist import sharding as shd
    mesh = shd.as_mesh(mesh)
    cfg = _moe_cfg(cfg, _ndp(mesh))    # device-local MoE sort, as the reference

    def prefill_fn(params, batch, cache):
        logits, new_cache, _ = tf.forward(
            params, batch["tokens"].long(), cfg, cache=cache,
            frames=batch.get("frames"), img_emb=batch.get("img_emb"),
            abft=opts.abft)
        # a copy of the last row, so that the [B, S, V] logits go with it
        return logits[:, -1].contiguous(), new_cache

    in_sh, out_sh = _serve_shardings(cfg, mesh, shape, opts)
    return prefill_fn, in_sh, out_sh


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     opts: StepOptions = StepOptions()):
    """decode_* / long_* shapes: one new token against a seq_len cache.
    ``(serve_fn, in_shardings, out_shardings)``: ``serve_fn(params, batch,
    cache) -> (logits [B, V], cache)`` decodes ``batch["tokens"]`` [B, 1]
    at position ``batch["pos"]`` (a scalar, the batch in lockstep), with
    ``img_emb`` where the config has it."""
    from repro_torch.dist import sharding as shd
    mesh = shd.as_mesh(mesh)
    cfg = _moe_cfg(cfg, _ndp(mesh))    # device-local MoE sort, as the reference

    def serve_fn(params, batch, cache):
        return tf.decode_step(
            params, batch["tokens"].long(), batch["pos"].long(), cache, cfg,
            img_emb=batch.get("img_emb"), abft=opts.abft)

    in_sh, out_sh = _serve_shardings(cfg, mesh, shape, opts)
    return serve_fn, in_sh, out_sh

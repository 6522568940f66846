"""Checksum-verified reductions: the paper's claim that the ABFT encoding
rides the collective.

`abft_psum` / `abft_psum_tree` pack Huang-Abraham row and column checksums
of each (2-D-viewed) contribution into the same sum as the data; after the
reduction the checksums of the sum must equal the sum of the checksums
(linearity), which detects a corruption injected into the reduction and
locates and corrects a single corrupted element.  Extra traffic: about
2 sqrt(n) floats per leaf.

The reference runs these inside a manual-collective region and reduces
over mesh axes.  The port takes the contributions stacked on a leading
shard axis, ``x[k]`` being shard k's contribution, and reduces over that
axis; at extent 1 this is the reference on its 1 x 1 mesh.  The algebra is
the reference's: the grid, the packed checksums, the thresholds, the
location and the repair.

`ef_psum_tree` is the int8 error-feedback quantized mean of the DP
gradients: each shard's contribution plus its carried residual is
quantized to int8 with a per-shard fp32 scale, and the quantization error
is the next step's residual.  Its ``int8`` wire is the reference's
compressed exchange (all-to-all of the int8 payloads, a segment mean per
shard, requantized and all-gathered), computed here on the stacked
payloads.  `ef_wire_bytes` is the per-device wire accounting of the
uncompressed and the compressed gradient reduction.

The reductions announce what a device would send to
`launch.hlo_accounting` through `note_collective`: one line per collective
the reference issues, with its kind and per-device output bytes (the
logical mesh moves nothing, so this is the only record of the wire).

Counterpart of the reference package's ``repro/dist/collectives.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.chaos.faults import register_surface
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["ef_psum_tree", "abft_psum", "abft_psum_tree", "ef_wire_bytes",
           "note_collective", "collective_hooks"]

# checksums riding the reduction see a corruption of the reduction itself;
# they cannot see garbage that was already in the contribution when its
# checksums were taken (that blind spot is the *_at_rest ledger entries)
register_surface(
    "dist.collectives/abft_psum", owner=__name__, protected=True,
    promise="tolerance",
    detector="Huang-Abraham row/column checksums packed into the same sum "
             "(linearity residual); single corrupted element located "
             "exactly, repaired by subtracting the row residual",
    kinds=("sdc_collective",),
    note="repair is a float subtraction of the residual: near-exact "
         "(~ulp(delta)), not bit-exact; the train-side promise is "
         "tolerance, the serving engine's argmax token stream absorbs it "
         "to bit-identity (see serve.engine/logits_reduce)")

_EPS32 = float(torch.finfo(torch.float32).eps)

# callables (kind, per-device output bytes) that see every collective the
# reductions stand for; `launch.hlo_accounting.account` installs one
collective_hooks: list = []


def note_collective(kind: str, nbytes: int) -> None:
    """Report one collective of ``kind`` ("all-reduce", "reduce-scatter",
    "all-to-all", "all-gather") whose per-device output is ``nbytes``.
    Callers report only reductions over more than one shard: over one,
    nothing moves."""
    for hook in collective_hooks:
        hook(kind, nbytes)


def _quant(x: torch.Tensor):
    """Per-shard int8 quantization of ``x`` [ndp, ...]: ``(q int8, scale
    fp32 [ndp])`` with ``scale = max(max|x|, 1e-30) / 127`` and ``q =
    clip(round(x / scale), -127, 127)`` (round half to even, as
    ``jnp.round``)."""
    flat = x.reshape(x.shape[0], -1)
    scale = torch.clamp(flat.abs().amax(dim=1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(flat / scale[:, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(x.shape), scale


def _ef_psum(x: torch.Tensor, ndp: int):
    """The ``psum`` wire: dequantized payloads summed in fp32."""
    q, scale = _quant(x)
    deq = q.float() * scale.reshape((-1,) + (1,) * (x.dim() - 1))
    if ndp > 1:
        note_collective("all-reduce", deq[0].numel() * 4)
    mean = deq[0].clone()
    for j in range(1, ndp):
        mean += deq[j]
    return mean / ndp, x - deq, {"q": q, "scale": scale}


def _ef_int8(x: torch.Tensor, ndp: int):
    """The ``int8`` wire on stacked payloads: shard i owns segment i of
    every shard's int8 payload (the reference's all-to-all), averages it
    with the per-shard scales, requantizes it (its all-gather) and feeds
    its segment's requantization error, times ``ndp``, back through its
    own residual."""
    shape = x.shape[1:]
    flat = x.reshape(ndp, -1)
    size = flat.shape[1]
    seg = -(-size // ndp)
    padded = torch.nn.functional.pad(flat, (0, seg * ndp - size))
    q, scale = _quant(padded)                                 # [ndp, ndp*seg]
    local_err = flat - (q.float() * scale[:, None])[:, :size]
    chunks = q.reshape(ndp, ndp, seg)                         # [shard, owner]
    note_collective("all-to-all", ndp * seg)
    note_collective("all-gather", ndp * 4)
    seg_sum = chunks[0].float() * scale[0]
    for j in range(1, ndp):
        seg_sum += chunks[j].float() * scale[j]
    seg_mean = seg_sum / ndp                                  # [owner, seg]
    q2, s2 = _quant(seg_mean)
    note_collective("all-gather", ndp * seg)
    note_collective("all-gather", ndp * 4)
    deq2 = q2.float() * s2[:, None]
    mean = deq2.reshape(-1)[:size].reshape(shape)
    seg_err = torch.zeros((ndp, ndp, seg), dtype=torch.float32,
                          device=x.device)
    own = torch.arange(ndp, device=x.device)
    seg_err[own, own] = ndp * (seg_mean - deq2)
    new_r = local_err + seg_err.reshape(ndp, -1)[:, :size]
    return mean, new_r.reshape(x.shape), {"q": q, "scale": scale, "q2": q2,
                                          "scale2": s2}


def ef_psum_tree(grads, residual, dp_axes, ndp: int, *, wire: str = "psum",
                 with_info: bool = False):
    """int8 error-feedback quantized DP gradient mean over the stacked
    shard axis of every leaf (each ``[ndp, ...]``, as `abft_psum_tree`
    takes them; ``residual`` the same tree in fp32).

    Per leaf: add the carried residual, quantize each shard's sum to int8
    with its own fp32 scale, reduce the dequantized payloads, and keep the
    quantization error as the next step's residual.  Returns
    ``(mean_grads, new_residual)``: the mean leaves ``[...]`` in fp32 (the
    value every shard of the reference ends with), the residual leaves
    ``[ndp, ...]``.  With ``with_info=True`` also a list, per leaf, of the
    int8 payloads and scales (``q``, ``scale``; the ``int8`` wire adds the
    requantized segments ``q2``, ``scale2``).

    wire:
      * "psum" — the dequantized values are summed: the gradient passes
        through the int8 bottleneck, the wire would carry fp32 (the
        reference's train step uses it);
      * "int8" — the reference's compressed exchange: shard i's segment i
        of every shard's payload is averaged, requantized and shared;
        both quantization errors feed the residual.  At ``ndp`` 1 it is
        the psum wire, as there.
    """
    if wire not in ("psum", "int8"):
        raise ValueError(f"unknown wire {wire!r}: expected 'psum' or 'int8'")
    _check_axes(dp_axes)
    one = _ef_int8 if (wire == "int8" and ndp > 1) else _ef_psum
    leaves = tree_leaves(grads)
    r_leaves = tree_leaves(residual)
    if len(r_leaves) != len(leaves):
        raise ValueError("the residual tree does not match the gradients")
    outs = []
    for g, r in zip(leaves, r_leaves):
        if g.shape[0] != ndp or tuple(r.shape) != tuple(g.shape):
            raise ValueError(f"leaf of shape {tuple(g.shape)} (residual "
                             f"{tuple(r.shape)}) is not stacked over {ndp} "
                             "shards")
        outs.append(one(g.float() + r.float(), ndp))
    mean = tree_unflatten(grads, [o[0] for o in outs])
    new_res = tree_unflatten(residual, [o[1] for o in outs])
    if with_info:
        return mean, new_res, [o[2] for o in outs]
    return mean, new_res


def _check_axes(axes) -> None:
    """The port reduces over the leading stacked axis and nothing else."""
    if axes not in (0, (0,), [0]):
        raise ValueError(f"the port reduces over the leading stacked shard "
                         f"axis (axes=0), got {axes!r}")


def abft_psum(x: torch.Tensor, axes=0, *, f: int = 2, mode: str = "correct",
              tol_factor: float = 256.0,
              inject: Optional[Tuple[int, float]] = None,
              inject_local=None, with_info: bool = False):
    """``x.sum(0)`` over the stacked shard axis, checksums riding the sum.

    ``x`` is ``[m, ...]``: shard k's contribution is ``x[k]``.  Each
    contribution is viewed as an R x C grid (``C = ceil(sqrt(n))``, ``R =
    ceil(n / C)``, zero-padded); its row sums (f >= 1) and column sums
    (f >= 2) are reduced with the data.  A residual between the reduced
    checksums and the checksums of the reduced data detects a corruption;
    the (argmax-row, argmax-col) intersection locates a single corrupted
    element, only when both families trip.

    mode: "verify" detects only; "correct" (f >= 2) also repairs.
    inject: ``(shard, delta)`` adds `delta` to element ``n // 2`` of that
    shard's contribution after its checksums are taken (a shard outside
    ``[0, m)`` injects nothing, as in the reference).  inject_local: the
    same drill with the selection made by the caller, a ``[m]`` vector of
    per-shard deltas (`chaos.faults.scatter_delta`).

    Returns ``(y, ok)`` (``ok`` a 0-d bool tensor, True when the checksums
    agree); with ``with_info=True`` also a dict of 0-d tensors: ``row``,
    ``col`` and ``index`` locate the corrupted element in the flattened
    leaf (-1 = not located), ``magnitude`` is the row residual and
    ``corrected`` says whether the repair was applied.
    """
    if mode not in ("verify", "correct"):
        raise ValueError(f"unknown mode {mode!r}: expected 'verify' or "
                         "'correct'")
    if mode == "correct" and f < 2:
        raise ValueError("correct mode needs f >= 2 (row AND column "
                         "checksums locate the fault)")
    if inject is not None and inject_local is not None:
        raise ValueError("pass either inject (shard, delta) or inject_local "
                         "(per-shard deltas), not both")
    _check_axes(axes)
    m = x.shape[0]
    shape, dtype, dev = tuple(x.shape[1:]), x.dtype, x.device
    v = x.float().reshape(m, -1)
    n = v.shape[1]
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    info = {"row": neg1, "col": neg1, "index": neg1,
            "magnitude": torch.zeros((), dtype=torch.float32, device=dev),
            "corrected": torch.zeros((), dtype=torch.bool, device=dev)}
    if n < max(f, 2):
        if inject is not None or inject_local is not None:
            raise ValueError(
                f"cannot inject into a {n}-element leaf: too small to "
                f"carry {f} checksums (pick a bigger leaf)")
        y, ok = x.sum(0), torch.ones((), dtype=torch.bool, device=dev)
        return (y, ok, info) if with_info else (y, ok)
    cdim = int(math.ceil(math.sqrt(n)))
    rdim = -(-n // cdim)
    pad = rdim * cdim - n

    def grid(vec):
        return F.pad(vec, (0, pad)).reshape(vec.shape[:-1] + (rdim, cdim))

    v2 = grid(v)
    rows = v2.sum(dim=-1)                           # row sums [m, R]
    cols = v2.sum(dim=-2) if f >= 2 else None       # col sums [m, C]
    if inject is not None:
        shard, delta = inject
        if 0 <= int(shard) < m:
            v = v.clone()
            v[int(shard), n // 2] += delta
    elif inject_local is not None:
        d = torch.as_tensor(inject_local, dtype=torch.float32, device=dev)
        v = v.clone()
        v[:, n // 2] += d.reshape(m)
    # one reduction of [v, rows, cols]: each position sums over the shards
    if m > 1:
        note_collective("all-reduce",
                        4 * (n + rdim + (cdim if f >= 2 else 0)))
    y = v.sum(0)
    total_rows = rows.sum(0)
    y2 = grid(y)

    scale = torch.mean(torch.abs(y)) + 1e-30
    row_res = y2.sum(dim=1) - total_rows                          # [R]
    row_bad = torch.max(torch.abs(row_res)) > \
        tol_factor * cdim * _EPS32 * scale
    ok = ~row_bad
    if f >= 2:
        col_res = y2.sum(dim=0) - cols.sum(0)                     # [C]
        col_bad = torch.max(torch.abs(col_res)) > \
            tol_factor * rdim * _EPS32 * scale
        ok = ok & ~col_bad
        # single DATA fault: the corrupted element is the intersection of
        # the offending row and column, and the row residual is the delta.
        # A fault on a CHECKSUM element trips only one family; repairing
        # then would corrupt healthy data, so both must trip.
        rr = torch.argmax(torch.abs(row_res))
        cc = torch.argmax(torch.abs(col_res))
        idx = torch.clamp(rr * cdim + cc, max=n - 1)
        located = row_bad & col_bad
        # gather, not row_res[rr]: indexing with a 0-d tensor reads it on
        # the host, which waits for the device
        mag = torch.where(located, row_res.gather(0, rr.reshape(1))[0], 0.0)
        info["row"] = torch.where(located, rr.to(torch.int32), neg1)
        info["col"] = torch.where(located, cc.to(torch.int32), neg1)
        info["index"] = torch.where(located, idx.to(torch.int32), neg1)
        info["magnitude"] = mag
        if mode == "correct":
            # adds -0.0 where nothing was located: a bitwise no-op
            y = y.index_add(0, idx.reshape(1), -mag.reshape(1))
            info["corrected"] = located
    y = y.reshape(shape).to(dtype)
    return (y, ok, info) if with_info else (y, ok)


def _normalize_events(inject):
    """``inject`` may be one (shard, delta) pair or a sequence of them."""
    if inject is None:
        return ()
    if isinstance(inject, (tuple, list)) and len(inject) == 2 \
            and not isinstance(inject[0], (tuple, list)):
        return (tuple(inject),)
    return tuple(tuple(ev) for ev in inject)


def abft_psum_tree(grads, dp_axes, ndp: int, *, mode: str = "verify",
                   f: int = 2, inject=None):
    """Checksum-verified mean over the stacked shard axis of every leaf of
    a tree (each leaf ``[ndp, ...]``).

    `abft_psum` per leaf, divided by `ndp`.  `inject` takes one
    ``(shard, delta)`` event or a sequence of them: event j corrupts the
    j-th leaf big enough to carry the checksums, so k events land in k
    different protected reductions, each carrying at most the single fault
    its own checksums can locate and correct.  Returns ``(mean_grads,
    all_ok)``.
    """
    _check_axes(dp_axes)
    leaves = tree_leaves(grads)
    for g in leaves:
        if g.shape[0] != ndp:
            raise ValueError(f"leaf of shape {tuple(g.shape)} is not "
                             f"stacked over {ndp} shards")
    events = _normalize_events(inject)
    inject_for = {}
    if events:
        eligible = [i for i, g in enumerate(leaves)
                    if g.numel() // ndp >= max(f, 2)]
        if len(eligible) < len(events):
            raise ValueError(
                f"{len(events)} injected events need as many leaves large "
                f"enough to carry checksums; only {len(eligible)} qualify")
        inject_for = dict(zip(eligible, events))
    outs, oks = [], []
    for i, g in enumerate(leaves):
        y, ok = abft_psum(g, 0, f=f, mode=mode, inject=inject_for.get(i))
        outs.append(y / ndp)
        oks.append(ok)
    if oks:
        all_ok = torch.stack(oks).all()
    else:
        all_ok = torch.ones((), dtype=torch.bool)
    return tree_unflatten(grads, outs), all_ok


# ---------------------------------------------------------------------------
# wire-byte accounting (no device work)
# ---------------------------------------------------------------------------


def ef_wire_bytes(param_shapes, ndp: int) -> dict:
    """Per-device gradient-reduction wire bytes: fp32 ring all-reduce
    against the int8-EF compressed exchange (``ef_psum_tree(wire="int8")``).

    The fp32 baseline sends ``2 S (ndp - 1) / ndp`` bytes a device for an
    S-byte payload (reduce-scatter and all-gather phases); the int8
    exchange sends the same two phases at one byte an element plus one
    fp32 scale per leaf per phase.  ``param_shapes`` is any tree of
    tensors (meta tensors included): only shapes are read, over the
    reference's stacked leaves (`dist.sharding.stacked_shapes`), so the
    leaf count is the reference's."""
    from repro_torch.dist.sharding import stacked_shapes
    leaves = tree_leaves(stacked_shapes(param_shapes))
    n_elems = sum(int(math.prod(x.shape)) for x in leaves)
    n_leaves = len(leaves)
    frac = (ndp - 1) / ndp if ndp > 1 else 0.0
    f32 = 2 * 4 * n_elems * frac
    int8 = 2 * 1 * n_elems * frac + 2 * 4 * n_leaves * frac
    return {
        "ndp": ndp,
        "grad_elems": n_elems,
        "f32_ring_bytes_per_device": f32,
        "int8_ef_bytes_per_device": int8,
        "saving": (f32 / int8) if int8 else 1.0,
    }

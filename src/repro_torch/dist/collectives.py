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

Counterpart of the reference package's ``repro/dist/collectives.py``; its
int8 error-feedback reduction (``ef_psum_tree``, ``ef_wire_bytes``) comes
with port slice 13.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.chaos.faults import register_surface
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["abft_psum", "abft_psum_tree"]

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

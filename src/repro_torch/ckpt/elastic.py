"""Elastic restore: re-place a checkpoint (or live state) onto a different
logical mesh, with a placement-diff plan of what moves.

When a pod is lost, training resumes on a smaller mesh, e.g. (2, 2, 2) ->
(2, 2), by restoring the latest checkpoint with the specs inferred for the
*new* mesh.  Param and optimizer-state specs are mesh-shape-agnostic
(`dist.sharding`'s name rules, the optimizer's own `adamw_opt_specs`,
through `train.step.state_specs`), so the same state places onto any
mesh; the global batch is re-split over the surviving DP extent
(`data.pipeline.DataPipeline.resplit`: sample order and schedule do not
change).

Three entry points, consumed by `ft.runtime.ElasticRuntime`:

  * `plan_reshard`     — the placement diff: per-leaf bytes, old and new
                         spec, whether the leaf's spec changed (ZeRO dims
                         move when the DP extent changes divisibility).
  * `reshard_restore`  — disk checkpoint -> survivor mesh (rung 3b).
  * `reshard_state`    — LIVE state -> new mesh through host memory
                         (the planned re-grow, or a rung-3a shrink whose
                         state survived in the diskless checkpoint).

On the logical mesh every leaf lives whole on the mesh's device, so the
specs are records and the bytes that move are the host round trip of
`reshard_state`, the honest cost of a pod-to-pod transfer.

Counterpart of the reference package's ``repro/ckpt/elastic.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.tree import (keystr, stacked_leaves_with_path, tree_leaves,
                              tree_map)

__all__ = ["reshard_restore", "reshard_state", "survivor_mesh",
           "plan_reshard", "ReshardPlan", "LeafMove"]


def survivor_mesh(failed_pods: int = 1, total_pods: int = 2, mesh=None,
                  device="cuda"):
    """Mesh over the surviving pods (the 'pod' axis dropped when one
    remains).

    With `mesh` given, its leading "pod" extent shrinks by `failed_pods`
    and the other axes are kept (on `mesh`'s device).  Without it, the
    production shape: 2 x 16 x 16 -> 16 x 16."""
    if mesh is not None:
        if "pod" not in mesh.axis_names:
            raise ValueError(f"mesh {dict(mesh.shape)} has no 'pod' axis "
                             "to lose")
        total_pods = mesh.shape["pod"]
        remaining = total_pods - failed_pods
        if remaining <= 0:
            raise ValueError("no survivors")
        rest_axes = tuple(a for a in mesh.axis_names if a != "pod")
        rest_shape = tuple(mesh.shape[a] for a in rest_axes)
        if remaining == 1:
            return shd.Mesh(rest_shape, rest_axes, mesh.device)
        return shd.Mesh((remaining,) + rest_shape, ("pod",) + rest_axes,
                        mesh.device)
    from repro_torch.launch.mesh import make_production_mesh
    remaining = total_pods - failed_pods
    if remaining <= 0:
        raise ValueError("no survivors")
    if remaining == 1:
        return make_production_mesh(multi_pod=False, device=device)
    return shd.Mesh((remaining, 16, 16), ("pod", "data", "model"), device)


# ---------------------------------------------------------------------------
# placement-diff planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafMove:
    """One leaf's reshard line item."""
    path: str
    nbytes: int
    spec_from: str
    spec_to: str
    respecced: bool      # PartitionSpec changed (e.g. ZeRO dim moved)


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """Placement diff between two mesh generations.

    `bytes_total` is the reshard bill (every byte lands on the new
    generation); `bytes_respecced` narrows it to leaves whose spec changed
    (a different ZeRO dim, a dim that stopped dividing): those need
    re-layout, not just re-placement."""
    mesh_from: Tuple[Tuple[str, int], ...]
    mesh_to: Tuple[Tuple[str, int], ...]
    leaves: Tuple[LeafMove, ...]

    @property
    def bytes_total(self) -> int:
        return sum(l.nbytes for l in self.leaves)

    @property
    def bytes_respecced(self) -> int:
        return sum(l.nbytes for l in self.leaves if l.respecced)

    @property
    def n_respecced(self) -> int:
        return sum(1 for l in self.leaves if l.respecced)

    def summary(self) -> dict:
        return {
            "mesh_from": dict(self.mesh_from),
            "mesh_to": dict(self.mesh_to),
            "n_leaves": len(self.leaves),
            "n_respecced": self.n_respecced,
            "bytes_total": self.bytes_total,
            "bytes_respecced": self.bytes_respecced,
        }

    def report(self, top: int = 8) -> str:
        """Human-readable placement diff, largest re-specced leaves first."""
        s = self.summary()
        lines = [f"reshard {s['mesh_from']} -> {s['mesh_to']}: "
                 f"{s['n_leaves']} leaves / {s['bytes_total']/2**20:.1f} MiB "
                 f"move; {s['n_respecced']} leaves / "
                 f"{s['bytes_respecced']/2**20:.1f} MiB change spec"]
        resp = sorted((l for l in self.leaves if l.respecced),
                      key=lambda l: -l.nbytes)
        for l in resp[:top]:
            lines.append(f"  {l.path}: {l.nbytes/2**20:.2f} MiB  "
                         f"{l.spec_from} -> {l.spec_to}")
        if len(resp) > top:
            lines.append(f"  ... and {len(resp) - top} more")
        return "\n".join(lines)


def _nbytes(leaf) -> int:
    return max(leaf.numel(), 1) * leaf.element_size()


def plan_reshard(state_like, old_mesh, new_mesh, opts=None,
                 cfg=None) -> ReshardPlan:
    """Diff the state placement between two meshes: the bill of materials
    `ft.runtime.ElasticRuntime` reports before a shrink or re-grow moves
    anything.  `state_like` is the train state (meta tensors do), in the
    port's layout or the reference's; both meshes' specs come from
    `train.step.state_specs`, one line per stacked leaf."""
    from repro_torch.train.step import StepOptions, state_specs

    opts = opts or StepOptions()
    stacked = shd.stacked_shapes(state_like)
    specs_old = tree_leaves(state_specs(stacked, old_mesh, opts, cfg))
    specs_new = tree_leaves(state_specs(stacked, new_mesh, opts, cfg))
    moves = []
    for (path, parts), so, sn in zip(stacked_leaves_with_path(stacked),
                                     specs_old, specs_new):
        moves.append(LeafMove(
            path=keystr(path), nbytes=_nbytes(parts[0][1]),
            spec_from=str(so), spec_to=str(sn),
            respecced=tuple(so) != tuple(sn)))
    return ReshardPlan(mesh_from=old_mesh.key(), mesh_to=new_mesh.key(),
                       leaves=tuple(moves))


# ---------------------------------------------------------------------------
# the two restore paths
# ---------------------------------------------------------------------------


def reshard_restore(manager, step: int, state_like, new_mesh, opts=None,
                    cfg=None):
    """Restore checkpoint `step` placed for `new_mesh` (rung 3b: disk).
    `state_like` is the saved state's tree in the port's layout (meta
    tensors do); every leaf comes back on the new mesh's device."""
    from repro_torch.train.step import StepOptions, state_specs

    opts = opts or StepOptions()
    specs = state_specs(state_like, new_mesh, opts, cfg)
    return manager.restore(step, state_like,
                           sharding_tree=shd.to_shardings(specs, new_mesh))


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of ``x`` into host memory: pinned where ``x``
    is on a GPU (the copy runs at the link's rate, not through pageable
    staging), a plain copy on the CPU."""
    if x.device.type == "cuda":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return h
    return x.detach().clone()


def reshard_state(state, new_mesh, opts=None, cfg=None):
    """Re-place LIVE state onto `new_mesh` through host memory.

    Used by the planned re-grow (nothing was lost, no rollback) and by
    the rung-3a shrink whose state survived disklessly.  Goes device ->
    host -> device deliberately, as the reference does: the host hop is
    the cost a pod-to-pod transfer pays, and what the reshard wall
    measures.  Every leaf lands whole on the new mesh's device, so the
    specs (`opts`, `cfg`) change no placement here."""
    host = tree_map(_host_copy, state)
    if any(x.device.type == "cuda" for x in tree_leaves(state)):
        torch.cuda.synchronize()
    dev = new_mesh.device
    out = tree_map(lambda h: h.to(dev, non_blocking=True), host)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out

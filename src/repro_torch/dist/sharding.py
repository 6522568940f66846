"""Name-based sharding rules over a logical mesh: params, batches, optimizer
state, KV caches.

A `Mesh` here is a shape over named axes placed on ONE torch device: it
never enumerates devices, so a (2, 16, 16) mesh is a shape, not 512 cards.
Its data-parallel (DP) axes are real where the port computes over them:
the train step splits the global batch over the DP extent and reduces the
shards' gradients over a stacked shard axis (`dist.collectives`), and the
diskless checkpoint encodes over as many logical shards.  Its ``model``
axis is a placement the specs record: every leaf stays whole on the
device, and only the serving engine's verified unembed splits over it.

The rules are the reference's, entry for entry:

  * **Mesh-shape-agnostic.**  Rules key on parameter *names* (wq/wo/gate/
    down/table/...) and on divisibility against the given mesh, never on a
    fixed mesh shape, so one state places onto any mesh, which is what
    `ckpt.elastic.reshard_restore` relies on after a pod loss.
  * **Model axis is named "model"; every other axis is data-parallel.**
    Multi-pod meshes add a leading "pod" axis that behaves as extra DP.
  * **Divisibility guards everywhere.**  A dim the mesh extent does not
    divide stays replicated instead of erroring.

Specs are computed on the reference's leaf layout: each layout group's
layers stacked into one ``[repeats, ...]`` leaf (`tree.stack_layers`),
because `zero_dim` picks the first unsharded dim that the DP extent
divides and so depends on that leading ``repeats`` dim.  The port's
per-layer trees go in as they are; the spec trees come out in the stacked
layout, leaf for leaf the reference's.

Counterpart of the reference package's ``repro/dist/sharding.py``.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.tree import stack_layers, tree_map

__all__ = [
    "MODEL_AXIS", "Mesh", "PartitionSpec", "P", "NamedSharding", "as_mesh",
    "dp_axes", "dp_extent", "batch_specs", "infer_param_specs", "zero1_spec",
    "zero_dim", "cache_specs", "to_shardings", "stacked_shapes",
    "map_with_path",
]

MODEL_AXIS = "model"

# Projections whose OUTPUT features (last dim) split over the model axis
# (Megatron column-parallel): QKV and gate/up enter a row-parallel partner.
_COL_PARALLEL = {
    "wq", "wk", "wv",              # attention / mlstm QKV
    "gate", "up",                  # dense + MoE FFN in-projections
    "in_proj", "x_proj",           # mamba
    "wz", "wi", "wf", "wo_gate",   # xlstm gates
    "router",                      # MoE router (over experts)
    "lm_head",
}
# Projections whose INPUT features (second-to-last dim) split over model
# (row-parallel): the matmul's contraction produces the partial sums.
_ROW_PARALLEL = {"wo", "down", "out_proj", "wout"}


# ---------------------------------------------------------------------------
# the logical mesh and its records
# ---------------------------------------------------------------------------


class PartitionSpec:
    """One leaf's placement: an entry per dim, each None, an axis name or a
    tuple of axis names.  Its tuple form and ``str`` compare with the
    reference's ``jax.sharding.PartitionSpec`` entry for entry.  Not a
    tuple, so the port's trees hold it as a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(tuple(e) if isinstance(e, list) else e
                              for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"PartitionSpec{self._entries!r}"

    __str__ = __repr__


P = PartitionSpec


class Mesh:
    """A logical mesh: ``shape`` (an ordered dict of axis -> size, as jax's
    ``mesh.shape``) and ``axis_names``, placed on one torch ``device``
    (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, shape, axis_names, device="cuda"):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh extents must be >= 1, got {shape}")
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, shape))
        self.device = torch.device(device)

    def key(self):
        """The mesh's shape as a hashable key (axis, size) pairs."""
        return tuple(self.shape.items())

    def __eq__(self, other):
        if not isinstance(other, Mesh):
            return NotImplemented
        return self.key() == other.key() and self.device == other.device

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, device={self.device})"


class NamedSharding:
    """A (mesh, spec) record: where one leaf is placed.  Every leaf of a
    logical mesh lives whole on the mesh's device; the spec records the
    layout the reference would give it."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec})"


def as_mesh(mesh, device="cuda") -> Mesh:
    """``mesh`` as a `Mesh` on ``device``: None is the 1 x 1 (data, model)
    mesh, a shape tuple names its axes (data, model) or (pod, data, model),
    a dict maps axes to sizes."""
    if isinstance(mesh, Mesh):
        return mesh if mesh.device == torch.device(device) \
            else Mesh(mesh.shape.values(), mesh.axis_names, device)
    if mesh is None:
        return Mesh((1, 1), ("data", MODEL_AXIS), device)
    if isinstance(mesh, dict):
        return Mesh(mesh.values(), mesh.keys(), device)
    shape = tuple(mesh)
    names = {1: ("data",), 2: ("data", MODEL_AXIS),
             3: ("pod", "data", MODEL_AXIS)}.get(len(shape))
    if names is None:
        raise ValueError(f"name the axes of a {len(shape)}-axis mesh: pass "
                         "a Mesh or a dict")
    return Mesh(shape, names, device)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def dp_axes(mesh: Mesh) -> tuple:
    """All mesh axes that are not the model axis, in mesh order: what the
    gradient reduction reduces over and what ZeRO shards over."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def _axes_extent(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def dp_extent(mesh: Mesh) -> int:
    """The product of the DP axes' sizes."""
    return _axes_extent(mesh, dp_axes(mesh))


def _model_extent(mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def _dp_entry(mesh):
    """The DP axes as a single PartitionSpec entry."""
    dp = dp_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def _entry_extent(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return _axes_extent(mesh, entry)
    return mesh.shape[entry]


def _path_names(path):
    return [k for k in path if isinstance(k, str)]


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree`` (dict keys and
    sequence indices make the path), keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def stacked_shapes(tree):
    """``tree`` in the reference's leaf layout, each tensor leaf a meta
    tensor of its shape and type (no storage): layer lists stacked into
    ``[repeats, ...]`` leaves; a tree already in that layout keeps it."""
    meta = tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta")
                    if isinstance(x, torch.Tensor) else x, tree)
    return stack_layers(meta)


# ---------------------------------------------------------------------------
# batch
# ---------------------------------------------------------------------------


def batch_specs(mesh: Mesh, global_batch: int) -> tuple:
    """Spec entries for a leading batch dim (length-1 tuple): the greedy
    prefix of the DP axes whose cumulative extent divides `global_batch`;
    replicated when nothing divides."""
    axes = []
    extent = 1
    for a in dp_axes(mesh):
        nxt = extent * mesh.shape[a]
        if global_batch % nxt == 0:
            axes.append(a)
            extent = nxt
    if not axes:
        return (None,)
    return (tuple(axes) if len(axes) > 1 else axes[0],)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def infer_param_specs(param_shapes, mesh: Mesh, cfg: Any = None):
    """PartitionSpec tree for a param tree (the port's, or one already in
    the reference's stacked layout), in the stacked layout.

    Column/row split over "model" by name, with divisibility guards: a dim
    the model extent does not divide stays replicated, so any param tree
    places on any mesh.  `cfg` is accepted for rule refinements; the rules
    are purely name-driven."""
    model = _model_extent(mesh)

    def rule(path, leaf):
        names = _path_names(path)
        ndim = len(leaf.shape)
        dims = [None] * ndim
        if not names or ndim == 0:
            return P()
        leaf_name = names[-1]
        owner = names[-2] if len(names) >= 2 else ""

        if leaf_name == "table":                       # embed [V, D]
            if leaf.shape[0] % model == 0:
                dims[0] = MODEL_AXIS
            return P(*dims)

        # linear params live as {"w": ..., "b": ...} under a named module;
        # MoE expert weights are raw arrays named gate/up/down under "moe"
        if leaf_name in ("w", "b"):
            module = owner
        elif owner == "moe" and leaf_name in ("gate", "up", "down"):
            module = leaf_name
        else:
            return P()                                  # norms, ssm vectors

        if module in _COL_PARALLEL and leaf.shape[-1] % model == 0:
            dims[-1] = MODEL_AXIS
        elif module in _ROW_PARALLEL and leaf_name == "w" and ndim >= 2 \
                and leaf.shape[-2] % model == 0:
            dims[-2] = MODEL_AXIS
        elif module == "down" and owner == "moe" and ndim >= 2 \
                and leaf.shape[-2] % model == 0:        # moe down [.., dff, D]
            dims[-2] = MODEL_AXIS
        return P(*dims)

    return map_with_path(rule, stacked_shapes(param_shapes))


# ---------------------------------------------------------------------------
# ZeRO sharding (optimizer state)
# ---------------------------------------------------------------------------


def zero_dim(spec, shape, mesh: Mesh) -> Optional[int]:
    """The dim a ZeRO shard splits over the DP axes: the first unsharded
    dim whose size the full DP extent divides; None when none does."""
    dp = dp_axes(mesh)
    if not dp:
        return None
    ndp = _axes_extent(mesh, dp)
    entries = list(spec) if spec is not None else []
    entries += [None] * (len(shape) - len(entries))
    for d, size in enumerate(shape):
        if entries[d] is None and size > 0 and size % ndp == 0:
            return d
    return None


def zero1_spec(spec, shape, mesh: Mesh):
    """``spec`` additionally sharded over the DP axes along its ZeRO dim;
    the identity when no dim divides."""
    d = zero_dim(spec, shape, mesh)
    if d is None:
        return spec if spec is not None else P()
    entries = list(spec) if spec is not None else []
    entries += [None] * (len(shape) - len(entries))
    entries[d] = _dp_entry(mesh)
    return P(*entries)


# ---------------------------------------------------------------------------
# KV / recurrent caches
# ---------------------------------------------------------------------------


def cache_specs(mesh: Mesh, global_batch: int, cfg: Any = None):
    """Rule ``(path, leaf) -> PartitionSpec`` for `map_with_path` over a
    cache tree of ``[repeats, batch, ...]`` leaves: the batch dim over DP
    when divisible, else batch-1 attention caches over their sequence; KV
    head dims over "model" when divisible; ``index`` counters replicate."""
    model = _model_extent(mesh)
    dp = _dp_entry(mesh)
    ndp = _entry_extent(mesh, dp)
    bentry = batch_specs(mesh, global_batch)[0]

    def rule(path, leaf):
        names = _path_names(path)
        key = names[-1] if names else ""
        if key == "index":
            return P()
        shape = leaf.shape
        ndim = len(shape)
        dims = [None] * ndim
        if ndim >= 2:
            if bentry is not None \
                    and shape[1] % _entry_extent(mesh, bentry) == 0:
                dims[1] = bentry
            elif key in ("k", "v") and ndim >= 3 and dp is not None \
                    and shape[2] % ndp == 0:
                dims[2] = dp                      # sequence-sharded KV cache
        if key in ("k", "v", "ck", "cv") and ndim >= 4 \
                and shape[3] % model == 0:
            dims[3] = MODEL_AXIS
        return P(*dims)

    return rule


# ---------------------------------------------------------------------------
# placement records
# ---------------------------------------------------------------------------


def to_shardings(spec_tree, mesh: Mesh):
    """PartitionSpec tree -> `NamedSharding` tree on `mesh`: the records
    placement reads (each leaf goes to the mesh's device, whole)."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)

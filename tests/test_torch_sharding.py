"""The port's sharding rules against the reference's, entry for entry.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names``, so they run here on a ``jax.sharding.AbstractMesh``
(no devices) at any size.  For every config of the registry at smoke size
and every mesh below, the port's `infer_param_specs`, `cache_specs`,
`batch_specs`, `zero_dim`, `zero1_spec`, `adamw_opt_specs` and
`state_specs` (on the port's per-layer trees, given out in the stacked
layout) must equal the reference's (on its stacked trees) leaf for leaf:
the same key names along each path, the same tuple of entries and the same
``str``.  Exact equality: specs are symbols, not numbers.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import list_configs
from repro.configs.base import smoke_config as jsmoke
from repro.dist import sharding as jshd
from repro.models import transformer as jtf
from repro.train.optimizer import adamw_opt_specs as jopt_specs
from repro.train.step import StepOptions as JOpts
from repro.train.step import init_state as jinit
from repro.train.step import state_specs as jstate_specs
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer as ttf
from repro_torch.train.optimizer import adamw_opt_specs
from repro_torch.train.step import StepOptions, state_shapes, state_specs
from repro_torch.tree import tree_leaves, tree_leaves_with_path

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 1, 1), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_BATCH, CACHE_LEN = 4, 32


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    """The reference's state and cache shapes for the smoke config."""
    cfg = jsmoke(arch)
    state = jax.eval_shape(functools.partial(init_state_ref, cfg=cfg),
                           jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: jtf.init_cache(cfg, CACHE_BATCH,
                                                  CACHE_LEN))
    return state, cache


def init_state_ref(key, cfg):
    return jinit(key, cfg, JOpts())


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = tsmoke(arch)
    return state_shapes(cfg), ttf.init_cache(cfg, CACHE_BATCH, CACHE_LEN,
                                             device="meta")


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [([getattr(k, "key", None) for k in path
              if isinstance(getattr(k, "key", None), str)], spec)
            for path, spec in flat]


def _port_leaves(tree):
    return [([k for k in path if isinstance(k, str)], spec)
            for path, spec in tree_leaves_with_path(tree)]


def _same(got, want):
    """Two spec trees equal leaf for leaf: key names, entries, str."""
    g, w = _port_leaves(got), _ref_leaves(want)
    assert len(g) == len(w)
    for (gp, gs), (wp, ws) in zip(g, w):
        assert gp == wp
        assert tuple(gs) == tuple(ws), (gp, gs, ws)
        assert str(gs) == str(ws), gp


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m)) for m, _ in MESHES])
@pytest.mark.parametrize("arch", list_configs())
def test_specs_equal_reference(arch, shape, axes):
    jmesh = AbstractMesh(shape, axes)
    mesh = make_mesh(shape, axes, device="cpu")
    assert dict(mesh.shape) == dict(jmesh.shape)
    assert mesh.axis_names == jmesh.axis_names
    assert shd.dp_axes(mesh) == jshd.dp_axes(jmesh)
    jstate, jcache = _ref_trees(arch)
    tstate, tcache = _port_trees(arch)
    cfg, jcfg = tsmoke(arch), jsmoke(arch)

    for b in (1, 2, 3, 8, 16, 32, 64):
        assert tuple(shd.batch_specs(mesh, b)) == jshd.batch_specs(jmesh, b)

    tp = shd.infer_param_specs(tstate["params"], mesh, cfg)
    jp = jshd.infer_param_specs(jstate["params"], jmesh, jcfg)
    _same(tp, jp)

    shapes = [x.shape for x in tree_leaves(
        shd.stacked_shapes(tstate["params"]))]
    jshapes = [x.shape for x in jax.tree.leaves(jstate["params"])]
    assert [tuple(s) for s in shapes] == [tuple(s) for s in jshapes]
    for (_, s), (_, js), sh in zip(_port_leaves(tp), _ref_leaves(jp),
                                   jshapes):
        assert shd.zero_dim(s, sh, mesh) == jshd.zero_dim(js, sh, jmesh)
        z, jz = shd.zero1_spec(s, sh, mesh), jshd.zero1_spec(js, sh, jmesh)
        assert tuple(z) == tuple(jz) and str(z) == str(jz)

    for zero1 in (False, True):
        _same(adamw_opt_specs(tp, tstate["params"], mesh, zero1=zero1),
              jopt_specs(jp, jstate["params"], jmesh, zero1=zero1))
    for kw in ({}, {"zero1": False}, {"fsdp": True}):
        _same(state_specs(tstate, mesh, StepOptions(**kw), cfg),
              jstate_specs(jstate, jmesh, JOpts(**kw), jcfg))

    for batch in (CACHE_BATCH, 1):
        tc = tcache if batch == CACHE_BATCH else ttf.init_cache(
            cfg, 1, CACHE_LEN, device="meta")
        jc = jcache if batch == CACHE_BATCH else jax.eval_shape(
            lambda: jtf.init_cache(jcfg, 1, CACHE_LEN))
        _same(shd.map_with_path(shd.cache_specs(mesh, batch, cfg), tc),
              jax.tree_util.tree_map_with_path(
                  jshd.cache_specs(jmesh, batch, jcfg), jc))


def test_mesh_records_and_production_meshes():
    """A logical mesh is a shape placed on one device: the production
    meshes build without enumerating devices, and `to_shardings` gives
    (mesh, spec) records whose device is the mesh's."""
    big = make_production_mesh(multi_pod=True, device="cpu")
    assert dict(big.shape) == {"pod": 2, "data": 16, "model": 16}
    assert shd.dp_extent(big) == 32
    assert dict(make_production_mesh(device="meta").shape) == {
        "data": 16, "model": 16}
    assert shd.as_mesh(None, "cpu").key() == (("data", 1), ("model", 1))
    assert shd.as_mesh((2, 2, 2), "cpu").axis_names == ("pod", "data",
                                                        "model")
    assert shd.as_mesh({"data": 4, "model": 2}, "cpu") == \
        make_mesh((4, 2), ("data", "model"), device="cpu")
    spec = shd.P(("pod", "data"), None, "model")
    assert str(spec) == str(JP(("pod", "data"), None, "model"))
    assert tuple(spec) == tuple(JP(("pod", "data"), None, "model"))
    assert shd.P() != shd.P(None) and len(shd.P(None)) == 1
    recs = shd.to_shardings({"a": spec, "b": [shd.P()]}, big)
    assert recs["a"].spec is spec and recs["b"][0].device.type == "cpu"
    with pytest.raises(ValueError, match="repeated"):
        make_mesh((2, 2), ("data", "data"))

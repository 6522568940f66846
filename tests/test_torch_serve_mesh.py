"""The port's serving engine on a logical (data, model) mesh against the
JAX reference.

Smoke Qwen2-0.5B (d 64, 2 layers, vocab 512) in fp32, the reference's
params carried over with ``convert.params_from_jax``.  On the mesh (4, 2)
the verified unembed reduces two feature slices; the reference's engine
runs on a one-device mesh with ``Auto`` axes (its (4, 2) mesh needs 8
devices).  The token streams must be equal exactly: a split reduction and
a repaired logit differ from the one-slice sum by fp32 rounding, which the
argmax absorbs.  The specs the engine records must equal the reference's
on a ``jax.sharding.AbstractMesh`` entry for entry.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs.base import smoke_config as jsmoke
from repro.dist import sharding as jshd
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.dist.sharding import Mesh
from repro_torch.ft.failures import SDCInjector, SDCPlan
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import (PagedServeEngine, Request,
                                      ServeEngine)
from repro_torch.tree import tree_leaves_with_path

ARCH = "qwen2-0.5b"
SLOTS, MAX_LEN, N_REQ, PLEN, GEN = 4, 48, 4, 8, 5


@pytest.fixture(scope="module")
def params():
    pj = jtf.init_params(jax.random.PRNGKey(0), jsmoke(ARCH))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), tsmoke(ARCH))


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, tsmoke(ARCH).vocab_size, PLEN).tolist()
            for _ in range(N_REQ)]


def _drive(eng, req_cls):
    for i, p in enumerate(_prompts()):
        eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=GEN))
    return {r.rid: list(r.output) for r in eng.run()}


def _ref_tokens(pj):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    eng = JEngine(jsmoke(ARCH), pj, slots=SLOTS, max_len=MAX_LEN, mesh=mesh,
                  abft_reduce="correct")
    return _drive(eng, JRequest)


@pytest.mark.parametrize("sdc", [None, ((1, 1, 1e4),),
                                 ((0, 1, -3e4), (2, 0, 1e3))])
def test_mesh_engine_emits_reference_tokens(params, sdc):
    """(4, 2): the tokens of the reference's engine; an SDC on model shard
    1 (and one on shard 0) is detected, located and corrected."""
    pj, pt = params
    eng = ServeEngine(tsmoke(ARCH), pt, slots=SLOTS, max_len=MAX_LEN,
                      mesh=(4, 2), abft_reduce="correct",
                      sdc=SDCInjector(SDCPlan(sdc)) if sdc else None)
    assert eng.model_extent == 2 and dict(eng.mesh.shape) == {
        "data": 4, "model": 2}
    assert _drive(eng, Request) == _ref_tokens(pj)
    n = len(sdc) if sdc else 0
    assert (eng.stats.detections, eng.stats.corrections) == (n, n)
    assert [e.shard for e in eng.stats.events] == \
        [s for _, s, _ in (sdc or ())]
    assert all(e.corrected and e.row >= 0 for e in eng.stats.events)


def test_mesh_engine_refuses_what_the_reference_refuses(params):
    """A plan aimed at shard 2 of model extent 2 is refused, as a d_model
    the model extent does not divide, as a mesh with no model axis."""
    pt = params[1]
    with pytest.raises(ValueError, match="model extent is 2"):
        ServeEngine(tsmoke(ARCH), pt, mesh=(4, 2), abft_reduce="verify",
                    sdc=SDCInjector(SDCPlan(((1, 2, 1.0),))))
    with pytest.raises(ValueError, match="must divide"):
        ServeEngine(tsmoke(ARCH), pt, mesh=(1, 3), abft_reduce="verify")
    with pytest.raises(ValueError, match="'model' mesh axis"):
        ServeEngine(tsmoke(ARCH), pt, mesh={"data": 2},
                    abft_reduce="verify")
    # unprotected: the mesh only records placements
    eng = ServeEngine(tsmoke(ARCH), pt, mesh={"data": 2})
    assert eng.model_extent == 1


def _same_specs(got, want):
    g = [([k for k in p if isinstance(k, str)], s)
         for p, s in tree_leaves_with_path(got)]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    w = [([getattr(k, "key") for k in p
           if isinstance(getattr(k, "key", None), str)], s)
         for p, s in flat]
    assert len(g) == len(w)
    for (gp, gs), (wp, ws) in zip(g, w):
        assert gp == wp and tuple(gs) == tuple(ws) and str(gs) == str(ws)


def test_mesh_engine_records_reference_specs(params):
    """The param and cache specs the engine records on (4, 2) equal the
    reference's placements on an abstract (4, 2) mesh; the paged engine
    takes the mesh through its keywords."""
    pj, pt = params
    jmesh = AbstractMesh((4, 2), ("data", "model"))
    eng = ServeEngine(tsmoke(ARCH), pt, slots=SLOTS, max_len=MAX_LEN,
                      mesh=(4, 2))
    _same_specs(eng.param_specs, jshd.infer_param_specs(pj, jmesh,
                                                        jsmoke(ARCH)))
    shapes = jax.eval_shape(lambda: jtf.init_cache(jsmoke(ARCH), SLOTS,
                                                   MAX_LEN))
    shapes = jax.tree_util.tree_map_with_path(
        lambda p, x: jax.ShapeDtypeStruct((x.shape[0], SLOTS), np.int32)
        if getattr(p[-1], "key", None) == "index" else x, shapes)
    _same_specs(eng.cache_specs, jax.tree_util.tree_map_with_path(
        jshd.cache_specs(jmesh, SLOTS, jsmoke(ARCH)), shapes))
    paged = PagedServeEngine(tsmoke(ARCH), pt, slots=SLOTS, max_len=MAX_LEN,
                             mesh=Mesh((4, 2), ("data", "model"), "cpu"),
                             abft_reduce="correct")
    assert paged.model_extent == 2
    assert _drive(paged, Request) == _ref_tokens(pj)


def test_serve_cli_takes_a_mesh(capsys):
    """``--mesh 4x2`` reaches the engine: a drilled run on model shard 1
    is corrected and emits the undrilled run's tokens."""
    fin, eng = tserve.main(["--device", "cpu", "--mesh", "4x2", "--reduce",
                            "correct", "--drill-step", "2", "--drill-shard",
                            "1", "--requests", "2", "--gen", "4"])
    assert eng.model_extent == 2
    assert eng.stats.corrections == 1
    clean, _ = tserve.run(ARCH, requests=2, gen=4, abft_reduce="correct",
                          mesh_shape=(4, 2), device="cpu", verbose=False)
    assert [r.output for r in fin] == [r.output for r in clean]
    assert "located=" in capsys.readouterr().out

"""The dispatch accountant (`launch.hlo_accounting`) and the dry run
(`launch.dryrun`) against the reference's HLO accountant and dry run.

The reference's ``tests/test_hlo_accounting.py`` programs, as eager
counterparts: a product counts 2 M^3, a loop of 8 counts 8 times, nested
loops 32, a batched einsum 4, the gradient through the loop 24 (8 forward
and 16 backward products), and a loop over a sliced stack counts each
slice, not the stack.  Then ``dryrun_cell`` at smoke size on a (1, 1)
mesh against the reference's compiled step of the same cell: the FLOPs are
the reference's ``account(compiled.as_text())["flops"]`` exactly, and the
argument bytes its ``memory_analysis().argument_size_in_bytes`` (for the
prefill and serve cells but for 8 bytes: the port's cache index leaves are
int64, the reference's int32).  A production-mesh cell plans on meta
tensors, the DP-shard and microbatch trips counted, not run.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.base import smoke_config as jsmoke
from repro.launch.hlo_accounting import account as jaccount
from repro.models import transformer as jtf
from repro.train.step import StepOptions as JOpts
from repro.train.step import build_prefill_step as jprefill
from repro.train.step import build_serve_step as jserve
from repro.train.step import build_train_step as jbuild
from repro.train.step import init_state as jinit
from repro.train.step import make_inputs as jinputs
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_accounting import Accountant, account
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.train.step import StepOptions
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = 128


def _flops(fn, *args):
    return account(fn, *args)["flops"]


def _chain(a, n):
    x = a
    for _ in range(n):
        x = x @ a
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_dot(device):
    a = torch.ones((M, M), device=device)
    assert _flops(lambda x: x @ x, a) == 2 * M ** 3


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_multiplies_by_trip_count(device):
    a = torch.ones((M, M), device=device)
    assert _flops(lambda x: _chain(x, 8), a) == 8 * 2 * M ** 3


def test_nested_loops():
    def nested(a):
        x = a
        for _ in range(8):
            for _ in range(4):
                x = x @ a
        return x

    assert _flops(nested, torch.ones((M, M))) == 32 * 2 * M ** 3


def test_batched_einsum():
    b = torch.ones((4, M, M))
    assert _flops(lambda x: torch.einsum("bij,bjk->bik", x, x), b) == \
        4 * 2 * M ** 3


def test_grad_through_loop():
    def grad(a):
        a = a.detach().requires_grad_(True)
        loss = torch.sum(_chain(a, 8) ** 2)
        return torch.autograd.grad(loss, a)[0]
    # forward 8 products, backward 2 x 8
    assert _flops(grad, torch.ones((M, M))) == 24 * 2 * M ** 3


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_sliced_stack_bytes_not_full_operand(device):
    """A slice of a stacked tensor counts at its own size: a loop over 64
    slices must not count the whole stack per trip."""
    stack = torch.ones((64, M, M), device=device)

    def f(s):
        acc = torch.zeros((M, M), device=device)
        for i in range(64):
            acc = acc + s[i]
        return acc
    r = account(f, stack)
    assert r["bytes"] < 64 * M * M * 4 * 10
    assert r["bytes"] == 64 * 3 * M * M * 4 + M * M * 4   # adds + zeros
    # the accumulator is the only live allocation at the end; two at most
    # at once (the old and the new sum)
    assert r["live_end_bytes"] == M * M * 4
    assert r["peak_bytes"] == 2 * M * M * 4


def test_convolution_and_collectives_and_launch_hooks():
    """Convolutions count 2 |out| C_in/groups x window; the stacked-axis
    reductions report their collectives; a kernel launch's GEMM counts
    through the launch hook."""
    from repro_torch.dist.collectives import (abft_psum_tree, ef_psum_tree,
                                              note_collective)
    from repro_torch.kernels import abft_matmul as kmm
    x = torch.ones((2, 4, 16, 16))
    w = torch.ones((8, 2, 3, 3))
    r = account(lambda a: torch.nn.functional.conv2d(a, w, groups=2), x)
    conv = 2 * (2 * 8 * 14 * 14) * 2 * 9
    assert r["flops"] == conv

    def grad(a):
        a = a.detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        y = torch.nn.functional.conv2d(a, wg, groups=2)
        return torch.autograd.grad(y.sum(), (a, wg))
    assert account(grad, x)["flops"] == 3 * conv   # forward, dx and dw
    g = {"w": torch.ones((4, 10, 10))}
    r = account(lambda t: ef_psum_tree(t, {"w": torch.zeros((4, 10, 10))},
                                       0, 4, wire="int8"), g)
    assert r["collective_bytes"] == {"all-to-all": 4 * 25,
                                     "all-gather": 4 * 4 * 2 + 4 * 25}
    r = account(lambda t: abft_psum_tree(t, 0, 4), g)
    assert r["collective_bytes"] == {"all-reduce": 4 * (100 + 10 + 10)}
    r = account(lambda t: abft_psum_tree({"w": t["w"][:1]}, 0, 1), g)
    assert r["collective_bytes"] == {}            # one shard moves nothing
    seen = []
    acct = Accountant()
    with acct:
        note_collective("all-gather", 7)
        for h in kmm.launch_hooks:
            h("abft_matmul", (torch.ones((3, 5)), torch.ones((5, 4))), ())
        seen.append(len(kmm.launch_hooks))
    assert acct.collective_bytes == {"all-gather": 7}
    assert acct.flops == 2 * 3 * 5 * 4 and seen == [1]
    assert kmm.launch_hooks == []


# ---------------------------------------------------------------------------
# the dry run against the reference's compiled step
# ---------------------------------------------------------------------------


ARCH = "qwen2-0.5b"


def _ref_compiled(shape, opts):
    """The reference's step of the cell on a one-device Auto mesh, jitted
    with its dry run's donation, lowered and compiled."""
    cfg = jsmoke(ARCH)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        if shape.kind == "train":
            fn, in_sh, out_sh = jbuild(cfg, mesh, shape, opts=opts)
            st = jax.eval_shape(lambda k: jinit(k, cfg, opts, mesh),
                                jax.random.PRNGKey(0))
            args, donate = (st, jinputs(cfg, shape)), (0,)
        else:
            build = jprefill if shape.kind == "prefill" else jserve
            fn, in_sh, out_sh = build(cfg, mesh, shape, opts=opts)
            ps = jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                                jax.random.PRNGKey(0))
            cs = jax.eval_shape(lambda: jtf.init_cache(
                cfg, shape.global_batch, shape.seq_len))
            args, donate = (ps, jinputs(cfg, shape), cs), (2,)
        return jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                       donate_argnums=donate).lower(*args).compile()


def _smoke_overrides():
    cfg = jsmoke(ARCH)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


@pytest.mark.parametrize("shape,kw", [
    (ShapeConfig("t", 32, 8, "train"), dict(remat=True)),
    (ShapeConfig("t", 32, 8, "train"), dict(remat=False)),
    (ShapeConfig("p", 32, 2, "prefill"), {}),
    (ShapeConfig("d", 32, 2, "decode"), {}),
], ids=["train-remat", "train", "prefill", "decode"])
def test_dryrun_cell_matches_reference_compiled_step(shape, kw):
    if shape.kind == "train":
        kw = dict(kw, microbatches=8)     # the dry run's own choice
    compiled = _ref_compiled(shape, JOpts(**kw))
    want_flops = jaccount(compiled.as_text())["flops"]
    want_args = compiled.memory_analysis().argument_size_in_bytes
    rec = dryrun.dryrun_cell(
        ARCH, shape, make_mesh((1, 1), ("data", "model"), device="meta"),
        opts=StepOptions(**kw), cfg_overrides=_smoke_overrides(),
        verbose=False)
    assert rec["step_flops"] == want_flops
    assert rec["flops_per_device"] == want_flops
    index_leaves = 0 if shape.kind == "train" else 2 * 4   # int64 vs int32
    assert rec["memory"]["argument_bytes"] == want_args + index_leaves
    assert rec["memory"]["alias_bytes"] <= rec["memory"]["output_bytes"]
    assert rec["memory"]["temp_bytes"] > 0
    assert "step_flops" in rec["exact"] and "memory.temp_bytes" in \
        rec["estimates"]


def test_dryrun_production_mesh_counts_trips_not_runs():
    """A train cell on the 16 x 16 production mesh plans on meta tensors:
    16 DP shards x 8 microbatches counted, one run; the FLOPs are 16
    times one shard's; the gradient wire is `ef_wire_bytes`', the
    reduction's collective the per-device fp32 gradient."""
    over = _smoke_overrides()
    shape = ShapeConfig("t", 32, 256, "train")
    mesh = make_production_mesh(device="meta")
    rec = dryrun.dryrun_cell(ARCH, shape, mesh, cfg_overrides=over,
                             verbose=False)
    # one shard's batch of 16 in the same 8 microbatches of 2
    one = dryrun.dryrun_cell(
        ARCH, ShapeConfig("t", 32, 16, "train"),
        make_mesh((1, 1), ("data", "model"), device="meta"),
        cfg_overrides=over, verbose=False)
    assert rec["devices"] == 256
    assert rec["step_flops"] == 16 * one["step_flops"]
    assert rec["flops_per_device"] == rec["step_flops"] / 256
    n = rec["grad_wire"]["grad_elems"]
    assert rec["grad_wire"]["ndp"] == 16
    assert rec["collective_bytes_per_device"] == {"all-reduce": 4 * n}
    assert rec["account_s"] < 60


def test_dryrun_cli_writes_the_reference_record_keys(tmp_path, capsys):
    """The CLI over one cell: a JSON per cell with the reference's record
    keys (and the port's exact/estimate labels)."""
    want = {"arch", "shape", "mesh", "devices", "tag", "flops_per_device",
            "bytes_accessed_per_device", "collective_bytes_per_device",
            "memory", "grad_wire"}
    assert dryrun.main(["--arch", ARCH, "--shape", "decode_32k",
                        "--meshes", "pod1,pod2", "--out",
                        str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*"))]
    assert [r["tag"] for r in recs] == ["pod1", "pod2"]
    for r in recs:
        assert want - {"grad_wire"} <= set(r)
        assert set(r["memory"]) >= {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes"}
    # the decode step's FLOPs split over 256 and 512 devices
    assert np.isclose(recs[0]["flops_per_device"],
                      2 * recs[1]["flops_per_device"])
    assert "planned OK" in capsys.readouterr().out

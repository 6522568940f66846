"""The port's diskless checkpoint, checksum trees, failure injection and
disk checkpoints against the JAX reference, on the same numpy inputs.

The cases of tests/test_diskless.py, tests/test_ckpt.py and the injector
cases of tests/test_ft_runtime.py run through both packages; checksums and
recovered leaves are compared leaf for leaf.  Encodes run the plain version
of kernel #3 here (a CPU tensor), the reference's einsum on its side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.disk import CheckpointManager as JManager
from repro.ckpt.diskless import DisklessCheckpoint as JDiskless
from repro.core import checksum as jcs
from repro.ft.failures import FailureInjector as JInjector
from repro.ft.failures import FailurePlan as JPlan
from repro_torch.ckpt.disk import CheckpointManager
from repro_torch.ckpt.diskless import DisklessCheckpoint
from repro_torch.chaos.faults import get_surface
from repro_torch.core import checksum as tcs
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.ft.runtime import FTPolicy, FTRuntime
from repro_torch.kernels import checksum_encode as kenc
from repro_torch.tree import tree_leaves, tree_map
from torch_port_helpers import to_np

# the reference test's recovery tolerances: fp32 solves, f = 1 and f = 2
TOL = {1: 1e-5, 2: 1e-4}


def _np_state(rs, p=4, dtype=np.float32):
    return {"w": rs.standard_normal((p, 8, 16)).astype(dtype),
            "m": rs.standard_normal((p, 8, 16)).astype(dtype),
            "count": np.asarray(3, np.int32)}


def _both(state_np):
    """The same numpy state as a JAX tree and a torch tree."""
    return (jax.tree.map(jnp.asarray, state_np),
            tree_map(lambda a: torch.from_numpy(np.array(a)), state_np))


def _leaves_close(got, want, tol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = to_np(g), to_np(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_encode_recover_single_failure(rs):
    p = 4
    js, ts = _both(_np_state(rs, p))
    jdc, tdc = JDiskless(p, f=1), DisklessCheckpoint(p, f=1)
    _leaves_close(tdc.encode(ts, step=10), jdc.encode(js, step=10), TOL[1])
    damaged = FailureInjector.damage(ts, 2, p)
    assert bool(torch.isnan(damaged["w"]).any())
    rec = tdc.recover(damaged, [2])
    _leaves_close(rec, jdc.recover(JInjector.damage(js, 2, p), [2]), TOL[1])
    np.testing.assert_allclose(rec["w"].numpy(), ts["w"].numpy(),
                               rtol=TOL[1], atol=TOL[1])
    assert int(rec["count"]) == 3          # odd leaves kept as they are


def test_recover_is_rollback_to_encode_point(rs):
    """Survivors advance past the encode; recovery returns the ENCODE
    state (bounded rollback), even if the live tensors were updated in
    place after the encode."""
    p = 4
    js, ts = _both(_np_state(rs, p))
    want = ts["w"].clone()
    jdc, tdc = JDiskless(p, f=1), DisklessCheckpoint(p, f=1)
    jdc.encode(js, step=5)
    tdc.encode(ts, step=5)
    ts["w"] += 1.0                         # the optimizer writing in place
    ts["m"] += 1.0
    rec = tdc.recover(FailureInjector.damage(ts, 0, p), [0])
    advanced = jax.tree.map(
        lambda x: x + 1.0 if x.dtype == jnp.float32 else x, js)
    _leaves_close(rec, jdc.recover(JInjector.damage(advanced, 0, p), [0]),
                  TOL[1])
    np.testing.assert_allclose(rec["w"].numpy(), want.numpy(), rtol=TOL[1],
                               atol=TOL[1])
    assert tdc.step == jdc.step == 5


def test_f2_two_simultaneous_failures(rs):
    p = 8
    js, ts = _both(_np_state(rs, p))
    jdc, tdc = JDiskless(p, f=2), DisklessCheckpoint(p, f=2)
    _leaves_close(tdc.encode(ts, 0), jdc.encode(js, 0), TOL[2])
    damaged = FailureInjector.damage(FailureInjector.damage(ts, 1, p), 6, p)
    rec = tdc.recover(damaged, [1, 6])
    jdam = JInjector.damage(JInjector.damage(js, 1, p), 6, p)
    _leaves_close(rec, jdc.recover(jdam, [1, 6]), TOL[2])
    np.testing.assert_allclose(rec["w"].numpy(), ts["w"].numpy(),
                               rtol=TOL[2], atol=TOL[2])


def test_capacity_exceeded_raises(rs):
    _, ts = _both(_np_state(rs, 4))
    dc = DisklessCheckpoint(4, f=1)
    with pytest.raises(RuntimeError):      # nothing encoded yet
        dc.recover(ts, [0])
    dc.encode(ts, 0)
    with pytest.raises(ValueError):
        dc.recover(ts, [0, 1])


def test_memory_overhead_shrinks_with_p():
    """The paper's economics: overhead = f/p -> 0 as p grows."""
    for p, f in [(4, 1), (256, 1), (16, 3)]:
        assert DisklessCheckpoint(p, f).memory_overhead() \
            == JDiskless(p, f).memory_overhead()
    assert DisklessCheckpoint(256, 1).memory_overhead() < 0.004


def test_reshard_onto_smaller_p(rs):
    """Elastic rung 3a: recover, re-split to the survivor extent,
    re-encode; the new topology is itself recoverable."""
    p, new_p = 4, 2
    js, ts = _both(_np_state(rs, p))
    jdc, tdc = JDiskless(p, f=1), DisklessCheckpoint(p, f=1)
    jdc.encode(js, step=7)
    tdc.encode(ts, step=7)
    jdc2, tdc2 = jdc.reshard(new_p, failed=[3]), tdc.reshard(new_p, failed=[3])
    assert tdc2.p == new_p and tdc2.step == 7
    _leaves_close(tdc2.snapshot(), jdc2.snapshot(), TOL[1])
    _leaves_close(tdc2._enc, jdc2._enc, TOL[1])
    glob = ts["w"].numpy().reshape(-1, 16)
    rec = tdc2.recover(FailureInjector.damage(tdc2.snapshot(), 1, new_p), [1])
    np.testing.assert_allclose(rec["w"].numpy().reshape(-1, 16), glob,
                               rtol=TOL[2], atol=TOL[2])
    assert int(rec["count"]) == 3


def test_reshard_without_failures_is_exact(rs):
    p = 2
    js, ts = _both(_np_state(rs, p))
    tdc = DisklessCheckpoint(p, f=1)
    tdc.encode(ts, step=3)
    tdc2 = tdc.reshard(4)
    jdc = JDiskless(p, f=1)
    jdc.encode(js, step=3)
    np.testing.assert_array_equal(tdc2.snapshot()["w"].numpy(),
                                  np.asarray(jdc.reshard(4).snapshot()["w"]))
    np.testing.assert_array_equal(
        tdc2.snapshot()["w"].numpy().reshape(-1, 16),
        ts["w"].numpy().reshape(-1, 16))


def test_snapshot_survives_donation_and_repeated_recovery(rs):
    """The snapshot owns its memory: freeing or overwriting the live
    buffers after the encode changes nothing, and two recoveries from one
    encode give the same state (recover returns copies)."""
    p = 4
    _, ts = _both(_np_state(rs, p))
    expected = ts["w"].numpy().copy()
    dc = DisklessCheckpoint(p, f=1)
    dc.encode(ts, 0)
    ts["w"].fill_(float("nan"))            # the live buffer is reused
    first = dc.recover({"w": torch.zeros((p, 8, 16)),
                        "m": torch.zeros((p, 8, 16)),
                        "count": torch.tensor(0)}, [1])
    np.testing.assert_allclose(first["w"].numpy(), expected, rtol=TOL[1],
                               atol=TOL[1])
    first["w"].add_(100.0)                 # the next step writes in place
    second = dc.recover(first, [2])
    np.testing.assert_allclose(second["w"].numpy(), expected, rtol=TOL[1],
                               atol=TOL[1])


def test_owned_encode_keeps_the_tree_without_a_copy(rs):
    _, ts = _both(_np_state(rs, 4))
    dc = DisklessCheckpoint(4, f=1)
    dc.encode(ts, 0, owned=True)
    assert dc._snapshot is ts
    dc.encode(ts, 0)
    assert dc._snapshot["w"] is not ts["w"]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_every_floating_leaf_shape_encodes_like_the_reference(rs, dtype):
    """1-D to 4-D leaves with leading axis p take the encode (the dispatch
    views them as [p, m, n]); an int leaf with that axis and a leaf whose
    leading axis is not p are kept as they are."""
    p = 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    shapes = {"a1": (p,), "a2": (p, 224), "a3": (p, 6, 896), "a4":
              (p, 6, 12, 10), "other": (3, 5)}
    raw = {k: rs.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    js = {k: jnp.asarray(v, jdt) for k, v in raw.items()}
    ts = {k: torch.from_numpy(v).to(tdt) for k, v in raw.items()}
    js["ints"] = jnp.arange(p * 3, dtype=jnp.int32).reshape(p, 3)
    ts["ints"] = torch.arange(p * 3, dtype=torch.int32).reshape(p, 3)
    tdc = DisklessCheckpoint(p, f=1)
    plain = kenc.plain_calls
    enc = tdc.encode(ts, 0)
    assert kenc.plain_calls == plain + 4   # the four [p, ...] float leaves
    jenc = JDiskless(p, f=1).encode(js, 0)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for k in shapes:
        assert tuple(enc[k].shape) == tuple(jenc[k].shape)
        np.testing.assert_allclose(to_np(enc[k]), to_np(jenc[k]), rtol=tol,
                                   atol=tol)
    assert enc["other"] is tdc._snapshot["other"]
    assert torch.equal(enc["ints"], ts["ints"])
    rec = tdc.recover(FailureInjector.damage(ts, 1, p), [1])
    for k in shapes:
        assert not bool(torch.isnan(rec[k]).any())


def test_bf16_recovery_error_is_within_one_ulp_of_the_shard_sum(rs):
    """The checksum of a bf16 leaf is stored in bf16 (as the reference's),
    so a recovered shard x = y - sum(survivors) is off by up to one bf16
    ulp of the checksum y, plus the rounding of x itself."""
    p = 4
    x32 = rs.standard_normal((p, 32, 64)).astype(np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    dc = DisklessCheckpoint(p, f=1)
    y = dc.encode({"x": x}, 0)["x"].float()
    rec = dc.recover({"x": x}, [2])["x"].float()
    err = (rec[2] - x[2].float()).abs()
    ulp_y = 2.0 ** (torch.floor(torch.log2(y[0].abs().clamp_min(1e-30)))
                    - 7)
    ulp_x = 2.0 ** (torch.floor(torch.log2(x[2].float().abs()
                                           .clamp_min(1e-30))) - 7)
    assert bool((err <= 0.5 * ulp_y + 0.5 * ulp_x + 1e-6).all())
    assert float(err.max()) > 0                 # not exact in bf16
    assert torch.equal(torch.cat([rec[:2], rec[3:]]),
                       torch.cat([x[:2], x[3:]]).float())


def test_verify_is_clean_at_zero_and_names_a_flipped_leaf(rs):
    p = 4
    js, ts = _both(_np_state(rs, p))
    tdc, jdc = DisklessCheckpoint(p, f=1), JDiskless(p, f=1)
    tdc.encode(ts, 0)
    jdc.encode(js, 0)
    ok, bad, worst = tdc.verify(tdc.snapshot())
    assert (ok, bad, worst) == (True, "", 0.0)
    flipped = tdc.snapshot()
    flipped["m"][1, 2, 3] += 1e4
    ok, bad, worst = tdc.verify(flipped)
    jflip = dict(js, m=js["m"].at[1, 2, 3].add(1e4))
    jok, jbad, jworst = jdc.verify(jflip)
    assert (ok, bad) == (jok, jbad) == (False, "['m']")
    np.testing.assert_allclose(worst, jworst, rtol=1e-5)
    flipped["w"][0, 0, 0] = float("nan")
    ok, bad, worst = tdc.verify(flipped)
    assert not ok and worst == float("inf") and bad == "['w']"


def test_pytree_encode_and_recover_match_reference(rs):
    p, f = 6, 2
    tree = {"a": rs.standard_normal((p, 3, 5)).astype(np.float32),
            "b": [rs.standard_normal((p, 7)).astype(np.float32)]}
    js = jax.tree.map(jnp.asarray, tree)
    ts = tree_map(torch.from_numpy, tree)
    ta, ja = tcs.checkpoint_matrix(f, p), jcs.checkpoint_matrix(f, p)
    ty, jy = tcs.encode_pytree(ts, ta), jcs.encode_pytree(js, ja)
    _leaves_close(ty, jy, 1e-5)
    lost = tree_map(lambda x: x.clone().index_fill_(
        0, torch.tensor([1, 4]), float("nan")), ts)
    rec = tcs.recover_pytree(lost, ty, ta, [1, 4])
    _leaves_close(rec, jcs.recover_pytree(js, jy, ja, [1, 4]), 1e-4)
    _leaves_close(rec, js, 1e-4)


def test_failure_plan_and_damage_match_reference(rs):
    for n, steps, p, seed in [(3, 20, 4, 0), (2, 30, 4, 0), (5, 12, 8, 7),
                              (40, 10, 4, 1)]:
        assert FailurePlan.random(n, steps, p, seed).events \
            == JPlan.random(n, steps, p, seed).events
    assert FailurePlan(((3, 1), (3, 1), (7, 2))).events == ((3, 1), (7, 2))
    inj = FailureInjector(FailurePlan(events=((3, 1), (3, 2), (7, 2))))
    assert inj.check(0) is None and inj.check(3) == 1 and inj.check(3) == 2
    assert inj.check(3) is None and inj.check(7) == 2
    js, ts = _both(_np_state(rs, 4))
    jd, td = JInjector.damage(js, 2, 4), FailureInjector.damage(ts, 2, 4)
    for k in ("w", "m"):
        np.testing.assert_array_equal(np.isnan(td[k].numpy()),
                                      np.isnan(np.asarray(jd[k])))
        assert not bool(torch.isnan(ts[k]).any())   # a copy was poisoned
    assert td["count"] is ts["count"]


def test_runtime_recovery_ladder(rs, tmp_path):
    """Diskless first; more than f losses fall back to the disk checkpoint;
    neither raises."""
    p = 4
    _, ts = _both(_np_state(rs, p))
    rt = FTRuntime(p, FTPolicy(diskless_every=1, disk_every=1, f=1),
                   ckpt_manager=CheckpointManager(tmp_path))
    rt.maybe_checkpoint(0, ts)
    rt.ckpt.wait()
    rec = rt.recover(FailureInjector.damage(ts, 3, p), [3])
    np.testing.assert_allclose(rec["w"].numpy(), ts["w"].numpy(),
                               rtol=TOL[1], atol=TOL[1])
    damaged = FailureInjector.damage(FailureInjector.damage(ts, 0, p), 1, p)
    rec = rt.recover(damaged, [0, 1])
    assert torch.equal(rec["w"], ts["w"])
    assert rt.recoveries == {"diskless": 1, "disk": 1, "sdc": 0}
    assert len(rt.timings["encode"]) == 1 and len(rt.timings["recover"]) == 2
    with pytest.raises(RuntimeError):
        FTRuntime(p, FTPolicy(f=1)).recover(ts, [0])


def test_runtime_step_drains_every_injector(rs):
    p = 4
    _, ts = _both(_np_state(rs, p))
    rt = FTRuntime(p, FTPolicy(diskless_every=1, f=2),
                   injector=[FailureInjector(FailurePlan(((2, 1),))),
                             FailureInjector(FailurePlan(((2, 3), (2, 1))))])
    rt.maybe_checkpoint(0, ts)
    assert rt._failed_shards(1) == []
    out = rt.step(2, ts, lambda s: s)
    assert rt.recoveries["diskless"] == 1
    np.testing.assert_allclose(out["w"].numpy(), ts["w"].numpy(),
                               rtol=TOL[2], atol=TOL[2])


def test_maybe_checkpoint_builds_the_view_only_when_due(rs):
    p = 4
    _, ts = _both(_np_state(rs, p))
    rt = FTRuntime(p, FTPolicy(diskless_every=3))
    built = []

    def view():
        built.append(1)
        return tree_map(lambda x: x.clone(), ts)
    for i in range(7):
        rt.maybe_checkpoint(i, view)
    assert len(built) == 3 and rt.diskless.step == 6
    assert rt.diskless._snapshot is not None


def test_surface_registered():
    s = get_surface("ckpt.diskless/shards")
    assert s.protected and s.kinds == ("shard_loss",)


# ---------------------------------------------------------------------------
# disk checkpoints (tests/test_ckpt.py)
# ---------------------------------------------------------------------------


def _disk_state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(3),
                       "h": torch.full((2, 3), v).to(torch.bfloat16) + 1e-3},
            "groups": [{"x": torch.arange(6.0).reshape(2, 3) * v}],
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_roundtrip_is_bit_exact_with_bf16(tmp_path, rs):
    mgr = CheckpointManager(tmp_path, keep=3)
    s = _disk_state(1.5)
    s["params"]["h"] = torch.from_numpy(
        rs.standard_normal((2, 3)).astype(np.float32)).to(torch.bfloat16)
    mgr.save(10, s, aux={"data_step": 10}, blocking=True)
    like = tree_map(lambda x: torch.empty_like(x, device="meta"), s)
    r = mgr.restore(10, like)
    for a, b in zip(tree_leaves(r), tree_leaves(s)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1), b.view(-1))
    assert torch.equal(r["params"]["h"].view(torch.int16),
                       s["params"]["h"].view(torch.int16))
    assert mgr.aux(10)["data_step"] == 10
    # the reference's manager keeps the same directory protocol
    jm = JManager(tmp_path / "jax", keep=3)
    jm.save(10, {"w": jnp.ones(3)}, aux={"data_step": 10}, blocking=True)
    assert sorted(p.name for p in (tmp_path / "jax" / "step_10").iterdir()) \
        == sorted(p.name for p in (tmp_path / "step_10").iterdir())


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for i in range(5):
        mgr.save(i, _disk_state(float(i)), blocking=True)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_does_not_block(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, _disk_state(2.0), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_restore_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _disk_state(), blocking=True)
    bad = _disk_state()
    bad["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        mgr.restore(0, bad)
    with pytest.raises(ValueError):
        mgr.restore(0, {"w": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        mgr.restore(9, _disk_state())


def test_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, _disk_state(), blocking=True)
    assert not list(tmp_path.glob("*.tmp"))


def test_failed_save_raises_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_3.tmp").write_text("a file where a directory goes")
    mgr.save(3, _disk_state(), blocking=False)
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    mgr.wait()                               # reported once

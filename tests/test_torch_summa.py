"""The port's checksum algebra (encode / recover, block encodings, detect,
block recovery) and its ABFT SUMMA against the JAX reference.

The reference's ``abft_summa`` runs on a device mesh, which this CPU host
cannot give it, so the port's stacked-grid SUMMA is held three ways: against
``A @ B`` in float64, with the reference's ``repro.core.verify`` on the port's
output, and (for flips on the plain update) with the reference's
``locate_and_correct`` repairing it.  One test replays a single process's
loop with chained calls of the reference's accumulate kernel on the same
panels.  The port's "cuda" local update runs the kernel's plain version on
a CPU tensor; the kernel itself runs in the ``gpu``-marked tests and in
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as core
from repro.kernels import ops as jops
from repro_torch.core.summa import _local_summa, _solve_static, _to_blocks
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ops
from repro_torch.launch import stress
from torch_port_helpers import assert_close

GRIDS = [(4, 1, 8), (4, 1, 128), (5, 2, 8), (5, 2, 128)]   # (grid, f, mb)
MULTI = [((0, 0), (1, 1)), ((0, 2), (2, 2)), ((1, 0), (1, 3)),
         ((0, 0), (1, 1), (2, 2)), ((3, 1), (0, 1))]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _operands(grid, f, mb, seed=0):
    rs = np.random.RandomState(seed)
    pr = grid - f
    a = rs.standard_normal((pr * mb, grid * mb)).astype(np.float32)
    b = rs.standard_normal((grid * mb, pr * mb)).astype(np.float32)
    spec = core.make_spec(f, pr, pr)
    a_enc, b_enc = core.encode_operands(_t(a), _t(b), spec)
    return a, b, spec, a_enc, b_enc


def _check(c_enc, a, b, spec, ext, *, consistent=True):
    """The stripped product against float64 A @ B, and the reference's
    verify on the encoded result."""
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = core.strip(c_enc, ext, ext).double().numpy()
    err = float(np.abs(got - want).max())
    # fp32 sums over K terms, and a host repair that cancels the flip
    assert err < 1e-3 + 2e-5 * float(np.abs(want).max()), err
    jspec = jcore.make_spec(spec.f, spec.pr, spec.pc)
    assert bool(jcore.verify(jnp.asarray(c_enc.numpy()), jspec).consistent) \
        == consistent


# ---------------------------------------------------------------------------
# Modules 1-4: checksum, encoding, detect, recovery
# ---------------------------------------------------------------------------


def test_checkpoint_matrix_encode_recover_match_reference(rs):
    """Integer-valued shards: encode bit-identical, recover exact."""
    x = rs.randint(-8, 9, (5, 6, 7)).astype(np.float32)
    for f in (1, 2, 3):
        a = core.checkpoint_matrix(f, 5)
        ja = jcore.checkpoint_matrix(f, 5)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        y = core.encode(_t(x), a)
        np.testing.assert_array_equal(y.numpy()[0],
                                      np.asarray(jcore.encode(x, ja))[0])
        assert_close(y, jcore.encode(x, ja), scale=float(np.abs(x).sum(0)
                                                         .max()) * 2)
        failed = [1, 3, 4][:f]
        lost = x.copy()
        lost[failed] = 7.0                        # ignored contents
        got = core.recover(_t(lost), y, a, failed)
        want = jcore.recover(jnp.asarray(lost), jcore.encode(x, ja), ja,
                             failed)
        np.testing.assert_allclose(got.numpy(), x, atol=1e-3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    with pytest.raises(ValueError):
        core.recover(_t(x), y, a, [0, 1, 2, 3])


@pytest.mark.parametrize("f", [1, 2])
def test_block_encodings_match_reference(rs, f):
    """encode_block_rows / cols / full, strip, split_full and block_views on
    integer data: bit-identical for the plain sum (f = 1, fp32 sums of small
    integers are exact), within the fp32 tolerance for the Gaussian rows."""
    spec = core.make_spec(f, 3, 4)
    jspec = jcore.make_spec(f, 3, 4)
    np.testing.assert_array_equal(spec.cc.numpy(), np.asarray(jspec.cc))
    np.testing.assert_array_equal(spec.cr.numpy(), np.asarray(jspec.cr))
    assert (spec.f, spec.pr, spec.pc) == (f, 3, 4)
    a = rs.randint(-8, 9, (3 * 5, 4 * 6)).astype(np.float32)
    pairs = [
        (core.encode_block_rows(_t(a), spec.cc),
         jcore.encode_block_rows(jnp.asarray(a), jspec.cc)),
        (core.encode_block_cols(_t(a), spec.cr),
         jcore.encode_block_cols(jnp.asarray(a), jspec.cr)),
        (core.encode_full(_t(a), spec), jcore.encode_full(jnp.asarray(a), jspec)),
    ]
    full, jfull = pairs[2]
    pairs.append((core.strip(full, 5 * f, 6 * f), jcore.strip(jfull, 5 * f,
                                                              6 * f)))
    pairs += list(zip(core.split_full(full, spec),
                      jcore.split_full(jfull, jspec)))
    pairs += list(zip(core.block_views(full, spec),
                      jcore.block_views(jfull, jspec)))
    for got, want in pairs:
        assert got.shape == np.asarray(want).shape
        if f == 1:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert_close(got, want, scale=float(np.abs(a).sum()))
    np.testing.assert_array_equal(core.strip(full, 5 * f, 6 * f).numpy(), a)
    # non-integer data: within the fp32 tolerance; bf16 keeps its dtype
    x = rs.standard_normal((3 * 4, 8)).astype(np.float32)
    assert_close(core.encode_block_rows(_t(x), spec.cc),
                 jcore.encode_block_rows(jnp.asarray(x), jspec.cc))
    xb = core.encode_block_rows(_t(x).bfloat16(), spec.cc)
    assert xb.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        core.encode_block_rows(_t(x[:10]), spec.cc)


@pytest.mark.parametrize("flip", [None, (7, 5, 300.0), (14, 19, -2e4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_and_locate_match_reference(rs, flip, dtype):
    """The same residuals, tolerance, verdict, location and repair."""
    spec = core.make_spec(1, 3, 3)
    jspec = jcore.make_spec(1, 3, 3)
    c = rs.standard_normal((3 * 6, 3 * 7)).astype(np.float32)
    c_f = core.encode_full(_t(c), spec)
    if dtype == "bfloat16":
        c_f = c_f.bfloat16()
    bad = c_f.clone()
    if flip is not None:
        bad[flip[0], flip[1]] += flip[2]
    jbad = jnp.asarray(bad.float().numpy(), getattr(jnp, dtype))
    got, want = core.verify(bad, spec), jcore.verify(jbad, jspec)
    assert bool(got.consistent) == bool(want.consistent) == (flip is None)
    assert_close(got.tol, want.tol)
    for x, y in zip(got[1:3], want[1:3]):
        assert_close(x, y, scale=float(np.abs(np.asarray(y)).max()) + 1.0)
    fixed, was, (r, cc) = core.locate_and_correct(bad, spec)
    jfixed, jwas, (jr, jc) = jcore.locate_and_correct(jbad, jspec)
    assert bool(was) == bool(jwas)
    if flip is not None:
        assert (r, cc) == (int(jr), int(jc)) == flip[:2]
        # c -= residual cancels |delta|: both sides land within a few
        # ulps of |delta| in the storage type of the clean value
        ulp = torch.finfo(bad.dtype).eps * abs(flip[2])
        for ref_val in (np.asarray(jfixed, np.float32), c_f.float().numpy()):
            np.testing.assert_allclose(fixed.float().numpy(), ref_val,
                                       rtol=0, atol=4 * ulp)
    else:
        assert torch.equal(fixed, bad)


@pytest.mark.parametrize("failed", [
    [(0, 1)], [(2, 2)], [(0, 1), (1, 2)], [(3, 0)],     # along columns
    [(0, 0), (1, 0)],                                   # two in a column
])
def test_recover_blocks_matches_reference(rs, failed):
    """Erased grid cells of an encoded block tensor come back, along
    columns where the column bound holds, else along rows."""
    f, pr, pc = 1, 3, 3
    spec = core.make_spec(f, pr, pc)
    jspec = jcore.make_spec(f, pr, pc)
    c = rs.standard_normal((pr * 4, pc * 5)).astype(np.float32)
    full = core.encode_full(_t(c), spec)
    blocks = full.reshape(pr + f, 4, pc + f, 5).permute(0, 2, 1, 3) \
        .contiguous()
    lost = blocks.clone()
    for (r, cc) in failed:
        lost[r, cc] = 0.0
    got = core.recover_blocks(lost, spec, failed)
    want = jcore.recover_blocks(jnp.asarray(lost.numpy()), jspec, failed)
    assert_close(got, want, scale=10.0)
    assert_close(got, blocks, scale=10.0)
    assert core.recoverable(failed, pr, pc, f) \
        == jcore.recoverable(failed, pr, pc, f) is True


@pytest.mark.parametrize("failed", [[(0, 0), (3, 0)], [(0, 0), (4, 0)],
                                    [(1, 2), (1, 4)]])
def test_recover_blocks_with_a_lost_checksum_cell(rs, failed):
    """f = 2: a data cell and a checksum cell lost in one line.  The port
    solves with the surviving checksum only and recomputes the lost one,
    so the whole block tensor comes back.  (The reference's
    recover_blocks solves with the first checksums, the lost one
    included, and misses by O(1) here; ROADMAP.md logs it.)"""
    f, pr, pc = 2, 3, 3
    spec = core.make_spec(f, pr, pc)
    c = rs.standard_normal((pr * 4, pc * 5)).astype(np.float32)
    blocks = core.encode_full(_t(c), spec).reshape(
        pr + f, 4, pc + f, 5).permute(0, 2, 1, 3).contiguous()
    lost = blocks.clone()
    for (r, cc) in failed:
        lost[r, cc] = 0.0
    got = core.recover_blocks(lost, spec, failed)
    assert_close(got, blocks, scale=10.0)


def test_recoverable_and_over_capacity_match_reference():
    for failed, f in [([(0, 0), (1, 1)], 1), ([(0, 0), (0, 1), (1, 0),
                                                (1, 1)], 1),
                      ([(0, 0), (1, 0), (2, 0)], 2), ([(0, 0), (1, 0)], 2)]:
        assert core.recoverable(failed, 3, 3, f) \
            == jcore.recoverable(failed, 3, 3, f)
    spec = core.make_spec(1, 3, 3)
    blocks = torch.zeros((4, 4, 2, 2))
    with pytest.raises(ValueError):
        core.recover_blocks(blocks, spec, [(0, 0), (0, 1), (1, 0), (1, 1)])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_solve_static_matches_numpy(rs, k):
    a = rs.standard_normal((k, k)) + 3 * np.eye(k)
    b = rs.standard_normal((k, 5))
    got = _solve_static(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(a, b), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# ABFT SUMMA on the stacked grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,f,mb", GRIDS)
def test_abft_summa_recovers_every_failure(grid, f, mb):
    """Clean and one process lost at every step x four places, on the
    kernel path (its plain version here): exact product, and a C_F the
    reference's verify accepts; G^3 accumulate calls per run."""
    a, b, spec, a_enc, b_enc = _operands(grid, f, mb)
    ext = f * mb
    before = kmm.acc_plain_calls
    c0 = core.abft_summa(a_enc, b_enc, grid, spec=spec, local_update="cuda")
    assert kmm.acc_plain_calls - before == grid ** 3
    _check(c0, a, b, spec, ext)
    for step in range(grid):
        for (r, c) in [(0, 0), (1, 2), (grid - 1, 1), (2, grid - 1)]:
            ev = core.FailureEvent(step=step, row=r, col=c)
            cx = core.abft_summa(a_enc, b_enc, grid, spec=spec, failure=ev,
                                 local_update="cuda")
            _check(cx, a, b, spec, ext)


@pytest.mark.parametrize("grid,f", [(4, 1), (5, 2)])
def test_torch_update_recovers_failures(grid, f):
    """The plain torch.matmul update ("auto" on a CPU tensor) through the
    same failures."""
    a, b, spec, a_enc, b_enc = _operands(grid, f, 8, seed=1)
    before = kmm.acc_plain_calls
    _check(core.abft_summa(a_enc, b_enc, grid, spec=spec), a, b, spec, f * 8)
    for step in range(grid):
        for (r, c) in [(0, 0), (1, 2), (grid - 1, 1), (2, grid - 1)]:
            ev = core.FailureEvent(step=step, row=r, col=c)
            cx = core.abft_summa(a_enc, b_enc, grid, spec=spec, failure=ev,
                                 local_update="torch")
            _check(cx, a, b, spec, f * 8)
    assert kmm.acc_plain_calls == before


@pytest.mark.parametrize("local_update", ["cuda", "torch"])
@pytest.mark.parametrize("devices", MULTI)
def test_simultaneous_failures(devices, local_update):
    """The reference's multi-failure cases on the f = 2, 5 x 5 grid."""
    grid, f, mb = 5, 2, 8
    a, b, spec, a_enc, b_enc = _operands(grid, f, mb, seed=2)
    ev = core.MultiFailureEvent(step=2, devices=devices)
    ev.check(f)
    cx = core.abft_summa(a_enc, b_enc, grid, spec=spec, failure=ev,
                         local_update=local_update)
    _check(cx, a, b, spec, f * mb)


def test_over_capacity_is_rejected():
    ev = core.MultiFailureEvent(2, ((0, 0), (1, 0), (2, 0)))
    with pytest.raises(ValueError):
        ev.check(2)
    with pytest.raises(ValueError):
        core.MultiFailureEvent(0, ((0, 0), (0, 1))).check(1)


@pytest.mark.parametrize("grid,f,mb", GRIDS)
def test_flips_repaired_in_kernel_or_by_host(grid, f, mb):
    """A mid-loop flip: on the kernel path the next step's prologue repairs
    it (one detecting launch, at the block's own (0, 0)); a last-step flip:
    the post-loop scrub repairs it.  On the plain update both stay, the
    reference's verify sees them and its locate_and_correct fixes them."""
    a, b, spec, a_enc, b_enc = _operands(grid, f, mb, seed=3)
    ext = f * mb
    jspec = jcore.make_spec(f, grid - f, grid - f)
    for ev in (core.BitflipEvent(step=1, row=0, col=1, delta=1e4),
               core.BitflipEvent(step=grid, row=1, col=0, delta=-3e3)):
        seen = []
        c_k = core.abft_summa(a_enc, b_enc, grid, spec=spec, bitflip=ev,
                              local_update="cuda",
                              on_stats=lambda k, r, c, s: seen.append(
                                  ((k, r, c), s.clone())))
        _check(c_k, a, b, spec, ext)
        hits = [(key, s) for key, s in seen if bool(s[..., 0].any())]
        if ev.step < grid:
            assert [key for key, _ in hits] == [(ev.step, ev.row, ev.col)]
            assert hits[0][1][0, 0, :4].tolist() == [1.0, 1.0, 0.0, 0.0]
        else:
            assert hits == []
        c_t = core.abft_summa(a_enc, b_enc, grid, spec=spec, bitflip=ev,
                              local_update="torch")
        jbad = jnp.asarray(c_t.numpy())
        assert not bool(jcore.verify(jbad, jspec).consistent)
        fixed, was, (r, c) = jcore.locate_and_correct(jbad, jspec)
        assert bool(was)
        assert (int(r), int(c)) == (ev.row * mb, ev.col * mb)
        _check(torch.from_numpy(np.asarray(fixed)), a, b, spec, ext)


@pytest.mark.parametrize("local_update", ["auto", "cuda", "torch"])
def test_plain_summa_equals_matmul(rs, local_update):
    a = rs.standard_normal((32, 32)).astype(np.float32)
    b = rs.standard_normal((32, 32)).astype(np.float32)
    before = kmm.acc_plain_calls
    c = core.summa(_t(a), _t(b), 4, local_update=local_update)
    np.testing.assert_allclose(c.numpy(), a.astype(np.float64) @ b,
                               atol=1e-4)
    assert kmm.acc_plain_calls - before == (64 if local_update == "cuda"
                                            else 0)
    with pytest.raises(ValueError):
        core.summa(_t(a), _t(b), 4, local_update="jnp")


def test_block_loop_matches_chained_reference_kernel():
    """Process (1, 2)'s loop, replayed with chained calls of the
    reference's accumulate kernel (Pallas, interpret mode) on the same
    panels and the port's tiling, with a flip after step 2: the same C
    block, carried state and per-step stats."""
    grid, f, mb = 4, 1, 128
    a, b, spec, a_enc, b_enc = _operands(grid, f, mb, seed=4)
    row, col, flip_step = 1, 2, 2
    ev = core.BitflipEvent(step=flip_step, row=row, col=col, delta=5e3)
    plan = ops.pick_blocks(mb, mb, mb, in_dtype=torch.float32, out_bytes=4,
                           carry=True, require_exact=True)
    seen = {}
    c_blk, (ccol, crow) = _local_summa(
        _to_blocks(a_enc, grid), _to_blocks(b_enc, grid), grid=grid,
        spec=spec, failure=None, bitflip=ev, preferred_dtype=torch.float32,
        plan=plan, on_stats=lambda k, r, c, s: seen.__setitem__((k, r, c), s))
    jplan = jops.BlockPlan(mb, mb, mb, plan.bm, plan.bn, mb, mb, mb, mb, 0)
    wm = jops.kernel_weights(mb)
    wn = jops.kernel_weights(mb).T
    a_np, b_np = a_enc.numpy(), b_enc.numpy()
    c_j = jnp.zeros((mb, mb), jnp.float32)
    st_j = jops.acc_state_zeros(jplan)
    for k in range(grid):
        if k == flip_step:
            c_j = c_j.at[0, 0].add(jnp.float32(ev.delta))
        c_j, st_j, stats = jops.abft_matmul_acc(
            jnp.asarray(a_np[row * mb:(row + 1) * mb, k * mb:(k + 1) * mb]),
            jnp.asarray(b_np[k * mb:(k + 1) * mb, col * mb:(col + 1) * mb]),
            c_j, st_j, plan=jplan, wm=wm, wn=wn, out_dtype=jnp.float32,
            backend="pallas")
        got = seen[(k, row, col)].numpy()
        np.testing.assert_array_equal(got[..., :4], np.asarray(stats)[..., :4])
        assert np.all(np.abs(got[..., 4:6] - np.asarray(stats)[..., 4:6])
                      <= 1e-5 * np.abs(np.asarray(stats)[..., 4:6])
                      + np.asarray(stats)[..., 6:7])
        assert got[..., 1].sum() == (1.0 if k == flip_step else 0.0)
    assert_close(c_blk[row, col], c_j)
    scale = 2.0 * float(np.abs(np.asarray(c_j)).sum(0).max())
    assert_close(ccol[row, col], st_j[0], scale=scale)
    assert_close(crow[row, col], st_j[1], scale=scale)


def test_stress_cli_on_cpu(capsys):
    """Three iterations of the paper's process-killer loop, on the plain
    update and on the kernel's plain version; the same draws as the
    reference's examples/abft_stress.py."""
    stress.main(["--device", "cpu", "--iters", "3"])
    out = capsys.readouterr().out
    assert out.count("OK") == 3 and "all 3 residual checks passed" in out
    res = stress.run(grid=4, block=32, iters=3, device="cpu",
                     local_update="cuda", verbose=False)
    assert max(res["residuals"]) < stress.THRESHOLD
    # the reference's loop draws the same events from RandomState(0)
    rs = np.random.RandomState(0)
    kinds = []
    for _ in range(3):
        rs.standard_normal((96, 128))
        rs.standard_normal((128, 96))
        kind = rs.randint(4)
        kinds.append(int(kind))
        if kind == 0:
            rs.randint(0, 4), rs.randint(0, 4), rs.randint(0, 4)
        elif kind == 1:
            rs.choice(4, 2, replace=False), rs.choice(4, 2, replace=False)
            rs.randint(0, 4)
        elif kind == 2:
            rs.randint(0, 4), rs.randint(0, 3), rs.randint(0, 3)
            rs.randint(2, 6)
        rs.standard_normal((96,))
    assert res["failures"] == sum({0: 1, 1: 2}.get(k, 0) for k in kinds)
    assert res["flips"] == kinds.count(2)


def test_stress_without_gpu_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the check is for a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stress.run(iters=1)


@pytest.mark.gpu
def test_abft_summa_on_the_kernel_on_card():
    """On a CUDA card "auto" runs every rank-kb update on the kernel: a
    failure and a mid-loop flip, G^3 launches, no plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py runs the SUMMA at full size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    grid, f, mb = 4, 1, 128
    a, b, spec, a_enc, b_enc = _operands(grid, f, mb)
    spec = core.make_spec(f, grid - f, grid - f, device="cuda")
    for kw in ({"failure": core.FailureEvent(1, 2, 0)},
               {"bitflip": core.BitflipEvent(2, 0, 1, 1e4)}):
        l0, p0 = kmm.acc_launches, kmm.acc_plain_calls
        c = core.abft_summa(a_enc.cuda(), b_enc.cuda(), grid, spec=spec, **kw)
        torch.cuda.synchronize()
        assert kmm.acc_launches - l0 == grid ** 3
        assert kmm.acc_plain_calls == p0
        _check(c.cpu(), a, b, spec, f * mb)


@pytest.mark.gpu
def test_stress_cli_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    l0 = kmm.acc_launches
    res = stress.run(grid=4, block=128, iters=3, device="cuda", verbose=False)
    assert max(res["residuals"]) < stress.THRESHOLD
    assert kmm.acc_launches - l0 == 3 * 4 ** 3

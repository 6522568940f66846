"""The port's accumulate step (kernel #2's plain version and the PyTorch
twin) and its carried-state algebra against the JAX reference.

The reference runs ``repro.kernels.ops.abft_matmul_acc(backend="pallas")``,
its Pallas kernel in interpret mode on the CPU.  Both sides use one pinned
tiling (128 x 128 unless a test says otherwise), since the tile is part of
the carried-state layout.  The port's "cuda" backend runs the kernel's plain
version on a CPU tensor; "torch" is the separate-op twin.  The CUDA kernel
itself is held against its plain version by the ``gpu``-marked test at the
end and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.abft_matmul import abft_matmul_pallas
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import build
from repro_torch.kernels import ops
from torch_port_helpers import assert_close, tf32, to_np, within_rtol

BACKENDS = ["cuda", "torch"]
FLIPS = [(0, 0, 1e4), (383, 511, -3e3), (200, 300, 1e6), (130, 40, 2.5e3),
         (37, 201, 1e30)]


def _round_up(x, b):
    return -(-x // b) * b


def _plans(m, k, n, bm=128, bn=128):
    """One tiling on both sides: the port's (k staged in 16-wide slabs, no
    padding in memory) and the reference's (zero-padded, k block dividing
    the padded k)."""
    pm, pn = _round_up(m, bm), _round_up(n, bn)
    tp = ops.BlockPlan(m=m, k=k, n=n, bm=bm, bn=bn, bk=kmm.KT, pm=pm,
                       pk=_round_up(k, kmm.KT), pn=pn, cost_bytes=0)
    jbk = 128 if k % 128 == 0 else 8
    jp = jops.BlockPlan(m=m, k=k, n=n, bm=bm, bn=bn, bk=jbk, pm=pm,
                        pk=_round_up(k, jbk), pn=pn, cost_bytes=0)
    return tp, jp


def _unpad_state(state, m, n):
    """The reference's padded state -> the port's layout, as numpy."""
    ccol, crow = (np.asarray(x) for x in state)
    return ccol[:, :, :n], crow[:, :m, :]


def _port(a, b, c, st, tp, backend, **kw):
    """One port call on numpy inputs -> numpy (c, (ccol, crow), stats)."""
    out_dtype = kw.pop("out_dtype", None)
    c_t, st_t, stats = ops.abft_matmul_acc(
        torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b)),
        torch.from_numpy(np.asarray(c)),
        tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in st),
        plan=tp, backend=backend, out_dtype=out_dtype, **kw)
    return c_t.numpy(), tuple(x.numpy() for x in st_t), stats.numpy()


def _ref(a, b, c, st, jp, m, n, **kw):
    """One reference call (Pallas, interpret mode); st in the port layout."""
    mt, nt = jp.pm // jp.bm, jp.pn // jp.bn
    ccol, crow = st
    ccol_p = np.zeros((mt, ccol.shape[1], jp.pn), np.float32)
    ccol_p[:, :, :n] = ccol
    crow_p = np.zeros((nt, jp.pm, crow.shape[2]), np.float32)
    crow_p[:, :m] = crow
    c_j, st_j, stats = jops.abft_matmul_acc(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
        (jnp.asarray(ccol_p), jnp.asarray(crow_p)), plan=jp,
        backend="pallas", **kw)
    return np.asarray(c_j), _unpad_state(st_j, m, n), np.asarray(stats)


def _zero_state(m, n, bm=128, bn=128, f=2):
    return (np.zeros((-(-m // bm), f, n), np.float32),
            np.zeros((-(-n // bn), m, f), np.float32))


def _state_scale(c):
    """Largest term of a checksum sum (weights are O(1))."""
    c = np.abs(np.asarray(c, np.float64))
    return 2.0 * float(max(c.sum(0).max(), c.sum(1).max()))


def _assert_stats(got, want):
    """Decisions and locations exactly; residuals within the detection
    tolerance the tile used; tolerance and scale within fp32 noise."""
    np.testing.assert_array_equal(got[..., :4], want[..., :4])
    tol = want[..., 6:7]
    assert np.all(np.abs(got[..., 4:6] - want[..., 4:6])
                  <= 1e-5 * np.abs(want[..., 4:6]) + tol)
    np.testing.assert_allclose(got[..., 6:8], want[..., 6:8], rtol=1e-5)


def _flip_setup(rs, m, k, n):
    a = rs.standard_normal((m, k)).astype(np.float32)
    b = rs.standard_normal((k, n)).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def flip_case():
    """384 x 256 x 512 under a pinned 128 x 128 tiling: the clean first step
    on both sides (tests/test_kernels.py's flip shape)."""
    rs = np.random.RandomState(0)
    m, k, n = 384, 256, 512
    a, b = _flip_setup(rs, m, k, n)
    tp, jp = _plans(m, k, n)
    c0 = np.zeros((m, n), np.float32)
    ref = _ref(a, b, c0, _zero_state(m, n), jp, m, n)
    port = {be: _port(a, b, c0, _zero_state(m, n), tp, be) for be in BACKENDS}
    return dict(m=m, k=k, n=n, tp=tp, jp=jp, ref=ref, port=port,
                za=np.zeros((m, k), np.float32), zb=np.zeros((k, n),
                                                             np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
def test_clean_chain_matches_reference_and_oneshot(rs, backend):
    """Two accumulate steps over a split k: C and state against the
    reference's chain and against the one-shot kernel; the port's second
    step re-verifies its own state with residual exactly 0."""
    m, k, n = 256, 512, 256
    a, b = _flip_setup(rs, m, k, n)
    h = k // 2
    tp, jp = _plans(m, h, n)
    c0 = np.zeros((m, n), np.float32)
    c1, st1, s1 = _port(a[:, :h], b[:h], c0, _zero_state(m, n), tp, backend)
    c2, st2, s2 = _port(a[:, h:], b[h:], c1, st1, tp, backend)
    j1 = _ref(a[:, :h], b[:h], c0, _zero_state(m, n), jp, m, n)
    j2 = _ref(a[:, h:], b[h:], j1[0], j1[1], jp, m, n)
    assert_close(c2, j2[0])
    scale = _state_scale(j2[0])
    for got, want in zip(st2, j2[1]):
        assert_close(got, want, scale=scale)
    _assert_stats(s2, j2[2])
    assert float(np.abs(s2[..., 4:6]).max()) == 0.0
    assert float(s2[..., 0].max()) == 0.0
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    co, colo, rowo = abft_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(wm), jnp.asarray(wn),
        bm=128, bn=128, bk=128, interpret=True)
    assert_close(c2, co)
    cs_col, cs_row = ops.reduce_state(tuple(torch.from_numpy(x) for x in st2),
                                      m, n)
    assert_close(cs_col, np.asarray(colo).sum(0), scale=scale)
    assert_close(cs_row, np.asarray(rowo).sum(0), scale=scale)


@pytest.mark.parametrize("r,c,delta", FLIPS)
def test_flip_located_and_repaired_like_reference(flip_case, r, c, delta):
    """A flipped C element between accumulate steps: the same detection,
    the same located (row, col), the same repair within the reference
    test's tolerance, on both port backends."""
    fc = flip_case
    m, n, tp, jp = fc["m"], fc["n"], fc["tp"], fc["jp"]
    clean, st1, _ = fc["ref"]
    bad = clean.copy()
    bad[r, c] += np.float32(delta)
    want = _ref(fc["za"], fc["zb"], bad, st1, jp, m, n)
    assert want[2][..., 1].max() == 1.0
    for be in BACKENDS:
        clean_t, st1_t, _ = fc["port"][be]
        bad_t = clean_t.copy()
        bad_t[r, c] += np.float32(delta)
        fixed, _, stats = _port(fc["za"], fc["zb"], bad_t, st1_t, tp, be)
        np.testing.assert_array_equal(stats[..., :4], want[2][..., :4])
        assert (stats[..., 2].max(), stats[..., 3].max()) == (r, c)
        scale = float(np.abs(clean_t).max())
        np.testing.assert_allclose(fixed, clean_t, rtol=1e-5,
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("backend", BACKENDS)
def test_integer_data_repair_is_bit_exact(rs, backend):
    """Integer-valued fp32 data: exact checksums, so the masked re-sum
    restores the flipped element bit for bit, as in the reference."""
    m = k = n = 256
    a = rs.randint(-4, 5, (m, k)).astype(np.float32)
    b = rs.randint(-4, 5, (k, n)).astype(np.float32)
    tp, jp = _plans(m, k, n)
    c0 = np.zeros((m, n), np.float32)
    clean, st1, _ = _port(a, b, c0, _zero_state(m, n), tp, backend)
    jclean, jst1, _ = _ref(a, b, c0, _zero_state(m, n), jp, m, n)
    np.testing.assert_array_equal(clean, jclean)
    # the plain-sum checksums of integers are exact; the Gaussian-weighted
    # ones round per summation order
    np.testing.assert_array_equal(st1[0][:, 0], jst1[0][:, 0])
    np.testing.assert_array_equal(st1[1][..., 0], jst1[1][..., 0])
    for x, y in zip(st1, jst1):
        assert_close(x, y, scale=_state_scale(clean))
    bad = clean.copy()
    bad[100, 7] += 2.0 ** 20
    za, zb = np.zeros_like(a), np.zeros_like(b)
    fixed, _, stats = _port(za, zb, bad, st1, tp, backend)
    jfixed, _, jstats = _ref(za, zb, bad, jst1, jp, m, n)
    assert stats[..., 1].max() == jstats[..., 1].max() == 1.0
    np.testing.assert_array_equal(fixed, clean)
    np.testing.assert_array_equal(fixed, jfixed)
    _assert_stats(stats, jstats)


def test_one_repair_per_tile_and_verify_off(rs):
    """Two flips in two tiles are both repaired, with the reference's
    stats; verify=False leaves the data alone and writes -1 sentinels."""
    m = k = n = 256
    a, b = _flip_setup(rs, m, k, n)
    tp, jp = _plans(m, k, n)
    c0 = np.zeros((m, n), np.float32)
    jclean, jst1, _ = _ref(a, b, c0, _zero_state(m, n), jp, m, n)
    za, zb = np.zeros_like(a), np.zeros_like(b)
    for be in BACKENDS:
        clean, st1, _ = _port(a, b, c0, _zero_state(m, n), tp, be)
        bad = clean.copy()
        bad[10, 20] += 5e3
        bad[200, 200] -= 4e3
        jbad = jclean.copy()
        jbad[10, 20] += 5e3
        jbad[200, 200] -= 4e3
        fixed, _, stats = _port(za, zb, bad, st1, tp, be)
        want = _ref(za, zb, jbad, jst1, jp, m, n)
        assert stats[..., 1].sum() == 2.0
        locs = {(int(r), int(c)) for r, c in stats[..., 2:4].reshape(-1, 2)
                if r >= 0}
        assert locs == {(10, 20), (200, 200)}
        np.testing.assert_array_equal(stats[..., :4], want[2][..., :4])
        np.testing.assert_allclose(fixed, clean, rtol=1e-5, atol=1e-3)
        out, _, s0 = _port(za, zb, bad, st1, tp, be, verify=False)
        jout, _, js0 = _ref(za, zb, jbad, jst1, jp, m, n, verify=False)
        assert float(np.abs(s0[..., :2]).max()) == 0.0
        assert float(s0[..., 2:4].max()) == -1.0
        np.testing.assert_array_equal(s0, js0)
        np.testing.assert_array_equal(out, bad)


@pytest.mark.parametrize("backend", BACKENDS)
def test_int8_data_flip_repairs_bit_exact(rs, backend):
    """A bit flip in the carried int32 data between chained int8 calls is
    located and repaired exactly, and the result is the reference's."""
    m = k = n = 256
    mk8 = lambda sh: rs.randint(-4, 5, size=sh).astype(np.int8)  # noqa: E731
    a1, a2, b1, b2 = mk8((m, k)), mk8((m, k)), mk8((k, n)), mk8((k, n))
    tp, jp = _plans(m, k, n)
    c0 = np.zeros((m, n), np.int32)
    kw = dict(out_dtype=torch.int32)
    c1, st1, _ = _port(a1, b1, c0, _zero_state(m, n), tp, backend, **kw)
    c2, _, _ = _port(a2, b2, c1, st1, tp, backend, **kw)
    bad = c1.copy()
    bad[7, 9] ^= 1 << 20
    c2f, _, stats = _port(a2, b2, bad, st1, tp, backend, **kw)
    jc2f, _, jstats = _ref(a2, b2, bad, st1, jp, m, n, out_dtype=jnp.int32)
    assert c2f.dtype == np.int32
    assert stats[..., 0].any() and stats[..., 1].any()
    np.testing.assert_array_equal(c2f, c2)
    np.testing.assert_array_equal(c2f, jc2f)
    np.testing.assert_array_equal(stats[..., :4], jstats[..., :4])


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_operands_no_false_alarm(rs, backend):
    """Clean chained bf16 accumulation stays under the dtype-aware
    tolerance, on both sides."""
    m = k = n = 256
    mkb = lambda sh: np.asarray(  # noqa: E731
        jnp.asarray(rs.standard_normal(sh), jnp.bfloat16))
    a1, a2, b1, b2 = mkb((m, k)), mkb((m, k)), mkb((k, n)), mkb((k, n))
    tp, jp = _plans(m, k, n)
    c0 = np.zeros((m, n), np.float32)
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).bfloat16()  # noqa
    c1, st1, _ = ops.abft_matmul_acc(bf(a1), bf(b1), torch.from_numpy(c0),
                                     ops.acc_state_zeros(tp), plan=tp,
                                     backend=backend)
    c2, _, stats = ops.abft_matmul_acc(bf(a2), bf(b2), c1, st1, plan=tp,
                                       backend=backend)
    j1 = _ref(a1, b1, c0, _zero_state(m, n), jp, m, n)
    j2 = _ref(a2, b2, j1[0], j1[1], jp, m, n)
    assert not stats[..., :2].any()
    assert not j2[2][..., :2].any()
    assert_close(c2, j2[0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_carried_state_flip_is_detect_only(rs, backend):
    """A flip in the carried plain-sum column checksum trips one residual
    family: detected, deliberately not repaired, data passed through — the
    chaos campaign's kernel_state_flip drill, on both sides."""
    m = k = n = 256
    a1, b1 = _flip_setup(rs, m, k, n)
    a2, b2 = _flip_setup(rs, m, k, n)
    tp, jp = _plans(m, k, n)
    c0 = np.zeros((m, n), np.float32)
    c1, st1, _ = _port(a1, b1, c0, _zero_state(m, n), tp, backend)
    c2, _, _ = _port(a2, b2, c1, st1, tp, backend)
    ccol_bad = st1[0].copy()
    ccol_bad.view(np.int32)[1, 0, 77] ^= 1 << 27
    c2f, _, stats = _port(a2, b2, c1, (ccol_bad, st1[1]), tp, backend)
    jc2f, _, jstats = _ref(a2, b2, c1, (ccol_bad, st1[1]), jp, m, n)
    assert stats[..., 0].any() and not stats[..., 1].any()
    np.testing.assert_array_equal(stats[..., :4], jstats[..., :4])
    np.testing.assert_array_equal(c2f, c2)
    assert_close(c2f, jc2f)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ragged_shape_matches_padded_reference(rs, backend):
    """200 x 136 x 328 on a 64 x 64 tiling: the port masks the ragged edges
    and keeps the unpadded state; the reference pads and is sliced back.
    A flip in the ragged corner tile is located and repaired on both."""
    m, k, n = 200, 136, 328
    a1, b1 = _flip_setup(rs, m, k, n)
    a2, b2 = _flip_setup(rs, m, k, n)
    tp, jp = _plans(m, k, n, 64, 64)
    c0 = np.zeros((m, n), np.float32)
    z = _zero_state(m, n, 64, 64)
    c1, st1, _ = _port(a1, b1, c0, z, tp, backend)
    j1 = _ref(a1, b1, c0, z, jp, m, n)
    assert st1[0].shape == (4, 2, n) and st1[1].shape == (6, m, 2)
    assert_close(c1, j1[0])
    for got, want in zip(st1, j1[1]):
        assert_close(got, want, scale=_state_scale(j1[0]))
    bad = c1.copy()
    bad[197, 325] += 3e3
    c2, st2, stats = _port(a2, b2, bad, st1, tp, backend)
    j2 = _ref(a2, b2, bad, st1, jp, m, n)
    assert stats.shape == (4, 6, kmm.STATS_WIDTH)
    assert (stats[3, 5, 2], stats[3, 5, 3]) == (197.0, 325.0)
    _assert_stats(stats, j2[2])
    assert_close(c2, j2[0])
    for got, want in zip(st2, j2[1]):
        assert_close(got, want, scale=_state_scale(j2[0]))


def test_tile_checksums_and_reduce_state_match_reference(rs):
    m, n, bm, bn = 256, 384, 128, 128
    c = rs.standard_normal((m, n)).astype(np.float32)
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    got = ops.tile_checksums(torch.from_numpy(c), torch.from_numpy(wm),
                             torch.from_numpy(wn), bm, bn)
    want = jops.tile_checksums(jnp.asarray(c), jnp.asarray(wm),
                               jnp.asarray(wn), bm, bn)
    scale = _state_scale(c)
    for x, y in zip(got, want):
        assert_close(x, y, scale=scale)
    for mm, nn in ((None, None), (200, 300)):
        g = ops.reduce_state(got, mm, nn)
        w = jops.reduce_state(want, mm, nn)
        for x, y in zip(g, w):
            assert_close(x, y, scale=scale)
    # ragged: the port's layout is the reference's padded one, sliced
    cr = c[:200, :300]
    got = ops.tile_checksums(torch.from_numpy(cr),
                             torch.from_numpy(wm[:, :200].copy()),
                             torch.from_numpy(wn[:300].copy()), bm, bn)
    pad = np.zeros_like(c)
    pad[:200, :300] = cr
    wm_p, wn_p = wm.copy(), wn.copy()
    wm_p[:, 200:] = 0.0
    wn_p[300:] = 0.0
    want = jops.tile_checksums(jnp.asarray(pad), jnp.asarray(wm_p),
                               jnp.asarray(wn_p), bm, bn)
    for x, y in zip(got, _unpad_state(want, 200, 300)):
        assert_close(x, y, scale=scale)


@pytest.mark.parametrize("flip", [None, (171, 333, -8e3), (5, 2, 1e30)])
def test_correct_from_state_matches_reference(rs, flip):
    m, n, bm, bn = 256, 384, 128, 128
    c = rs.standard_normal((m, n)).astype(np.float32)
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    state = jops.tile_checksums(jnp.asarray(c), jnp.asarray(wm),
                                jnp.asarray(wn), bm, bn)
    bad = c.copy()
    if flip is not None:
        bad[flip[0], flip[1]] += np.float32(flip[2])
    got = ops.correct_from_state(
        torch.from_numpy(bad), tuple(torch.from_numpy(np.asarray(x))
                                     for x in state),
        torch.from_numpy(wm), torch.from_numpy(wn), bm, bn)
    want = jops.correct_from_state(jnp.asarray(bad), state, jnp.asarray(wm),
                                   jnp.asarray(wn), bm, bn)
    for x, y in zip(got[1:], want[1:]):
        assert int(x) == int(y)
    assert bool(got[1]) == (flip is not None) == bool(got[2])
    if flip is not None:
        assert (int(got[3]), int(got[4])) == flip[:2]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[0].numpy(), c, rtol=1e-5, atol=1e-3)


def test_tile_verify_correct_matches_reference(rs):
    """The batched prologue twin on a padded tile grid with a flip in one
    tile and a state flip in another: same fixed tile and stats."""
    m, n, bm, bn = 256, 256, 128, 128
    c = rs.standard_normal((m, n)).astype(np.float32)
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    ccol, crow = (np.asarray(x).copy() for x in jops.tile_checksums(
        jnp.asarray(c), jnp.asarray(wm), jnp.asarray(wn), bm, bn))
    bad = c.copy()
    bad[30, 40] += 2e3
    ccol[1, 0, 200] += 5e2
    got = ops._tile_verify_correct(
        torch.from_numpy(bad), (torch.from_numpy(ccol), torch.from_numpy(crow)),
        torch.from_numpy(wm), torch.from_numpy(wn), bm, bn, tol_factor=64.0)
    want = jops._tile_verify_correct(
        jnp.asarray(bad), (jnp.asarray(ccol), jnp.asarray(crow)),
        jnp.asarray(wm), jnp.asarray(wn), bm, bn, tol_factor=64.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-3)
    _assert_stats(got[1].numpy(), np.asarray(want[1]))
    assert got[1][0, 0, 1] == 1.0 and got[1][1, 1, 0] == 1.0
    assert got[1][1, 1, 1] == 0.0


def test_planner_prefers_exact_tilings():
    """require_exact keeps only tilings with no ragged edge (None when
    there is none); the SUMMA step shape takes the 128 x 128 tile."""
    plan = ops.pick_blocks(3072, 3072, 3072, carry=True, require_exact=True)
    assert (plan.bm, plan.bn) == (128, 128) and plan.exact
    assert ops.pick_blocks(8, 8, 8, carry=True, require_exact=True) is None
    assert not ops.pick_blocks(8, 8, 8, carry=True).exact
    for p in ops.rank_blocks(96, 64, 160, require_exact=True):
        assert p.exact


def test_acc_wrapper_raises_instead_of_falling_back():
    """Only a CPU tensor gets the plain version: any other device launches
    the kernel or raises, and bad arguments raise before any launch."""
    meta = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,  # noqa
                                                    device="meta")
    cpu = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)  # noqa
    counts = (kmm.acc_launches, kmm.acc_plain_calls)
    with pytest.raises(RuntimeError):
        kmm.abft_matmul_acc_cuda(meta(32, 16), meta(16, 64), meta(32, 64),
                                 meta(1, 2, 64), meta(1, 32, 2), meta(2, 32),
                                 meta(64, 2), bm=32, bn=64)
    with pytest.raises(ValueError):     # state of another tiling
        kmm.abft_matmul_acc_cuda(cpu(32, 16), cpu(16, 64), cpu(32, 64),
                                 cpu(2, 2, 64), cpu(1, 32, 2), cpu(2, 32),
                                 cpu(64, 2), bm=32, bn=64)
    with pytest.raises(ValueError):     # C_in in another type than C_out
        kmm.abft_matmul_acc_cuda(cpu(32, 16), cpu(16, 64),
                                 cpu(32, 64, dt=torch.bfloat16),
                                 cpu(1, 2, 64), cpu(1, 32, 2), cpu(2, 32),
                                 cpu(64, 2), bm=32, bn=64,
                                 out_dtype=torch.float32)
    with pytest.raises(ValueError):
        ops.abft_matmul_acc(cpu(32, 16), cpu(16, 64), cpu(32, 64),
                            (cpu(1, 2, 64), cpu(1, 32, 2)),
                            plan=ops.pick_blocks(32, 16, 64), backend="jnp")
    assert (kmm.acc_launches, kmm.acc_plain_calls) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_summa_step_takes_tensor_cores_on_128x128(dtype):
    """The SUMMA step shape (3072^3, an exact tiling) keeps its 128 x 128
    tile, so the carried state's layout, and runs it on the tensor-core
    route, through the SUMMA's own planner as well."""
    from repro_torch.core.summa import _resolve_local_update
    plan = ops.pick_blocks(3072, 3072, 3072, in_dtype=dtype, out_bytes=4,
                           carry=True, require_exact=True)
    assert (plan.bm, plan.bn, plan.route) == (128, 128, "mma")
    assert plan.bk == kmm.MMA_SLAB // dtype.itemsize and plan.exact
    assert ops.smem_bytes(plan.bm, plan.bn, in_dtype=dtype) \
        <= ops.SMEM_DYNAMIC
    got = _resolve_local_update("cuda", 3072, 3072, 3072, dtype,
                                torch.device("cpu"))
    assert (got.bm, got.bn, got.route) == (128, 128, "mma")


@pytest.mark.parametrize("shape,want", [((256, 256, 256), (32, 32)),
                                        ((128, 128, 128), (16, 32))])
def test_campaign_and_small_summa_blocks_stay_on_cuda_cores(shape, want):
    """The chaos campaign's 256^3 drills (its runner's plan) and a 128^3
    SUMMA test block fill too few SMs for a 128-row tile: they stay on
    CUDA-core tiles."""
    from repro_torch.chaos.campaign import CampaignRunner
    from repro_torch.core.summa import _resolve_local_update
    plans = [ops.pick_blocks(*shape, carry=True, require_exact=True),
             _resolve_local_update("cuda", *shape, torch.float32,
                                   torch.device("cpu"))]
    if shape == (256, 256, 256):
        plans.append(CampaignRunner._acc_plan(*shape))
    for plan in plans:
        assert (plan.bm, plan.bn) == want and plan.route == "cuda_core"
        assert kmm.route_of(plan.bm, plan.bn, carry=True) == "cuda_core"


def test_acc_state_zeros_shapes_follow_the_tile_not_the_route():
    """The carried state's layout is the tile's: the SUMMA step's
    tensor-core plan gives the shapes a CUDA-core plan of the same tile
    gave, and every kernel-#2 tile has a route."""
    plan = ops.pick_blocks(3072, 3072, 3072, carry=True, require_exact=True)
    same_tile = ops.BlockPlan(m=3072, k=3072, n=3072, bm=128, bn=128,
                              bk=kmm.KT, pm=3072, pk=3072, pn=3072,
                              cost_bytes=0, route="cuda_core")
    got = [tuple(x.shape) for x in ops.acc_state_zeros(plan)]
    assert got == [tuple(x.shape) for x in ops.acc_state_zeros(same_tile)]
    assert got == [(24, 2, 3072), (24, 3072, 2)]
    for bm in kmm.TILES_M:
        for bn in kmm.TILES_N:
            want = "mma" if (bm, bn) in kmm.MMA_TILES else "cuda_core"
            assert kmm.route_of(bm, bn, carry=True) == want


def test_acc_wrapper_refuses_unbuilt_tiles_and_falls_back_nowhere():
    """A tile outside TILES_M x TILES_N raises on every device before any
    launch; a tensor-core tile on a non-CPU, non-CUDA tensor raises instead
    of taking the plain version."""
    cpu = lambda *s: torch.zeros(s)  # noqa: E731
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    counts = (kmm.acc_launches, kmm.acc_plain_calls)
    assert kmm.route_of(48, 64, carry=True) is None
    assert kmm.route_of(128, 256, carry=True) is None
    for bm, bn in ((48, 64), (128, 256), (256, 128)):
        with pytest.raises(ValueError):
            kmm.abft_matmul_acc_cuda(
                cpu(256, 16), cpu(16, 256), cpu(256, 256),
                cpu(-(-256 // bm), 2, 256), cpu(-(-256 // bn), 256, 2),
                cpu(2, 256), cpu(256, 2), bm=bm, bn=bn)
    with pytest.raises(RuntimeError):
        kmm.abft_matmul_acc_cuda(meta(256, 16), meta(16, 256),
                                 meta(256, 256), meta(2, 2, 256),
                                 meta(2, 256, 2), meta(2, 256), meta(256, 2),
                                 bm=128, bn=128)
    assert (kmm.acc_launches, kmm.acc_plain_calls) == counts


def _acc_3xtf32(c_in, a, b, stage, kstep=8):
    """The tensor-core route's fp32 arithmetic in plain fp32: C_in plus one
    partial a ring stage of ``stage`` k, each summed from zero in 8-deep k
    steps of the three 3xTF32 terms (small ones first) and added to the
    running sum by one fp32 add."""
    c = c_in.clone()
    for s0 in range(0, a.shape[1], stage):
        part = torch.zeros_like(c)
        for k0 in range(s0, min(s0 + stage, a.shape[1]), kstep):
            ah, bh = tf32(a[:, k0:k0 + kstep]), tf32(b[k0:k0 + kstep])
            al = tf32(a[:, k0:k0 + kstep] - ah)
            bl = tf32(b[k0:k0 + kstep] - bh)
            part = part + al @ bh
            part = part + ah @ bl
            part = part + ah @ bh
        c = c + part
    return c


@pytest.mark.parametrize("stage", [8, kmm.MMA_SLAB // 4])
def test_tensor_core_route_holds_fp32_level_with_a_large_carried_c_in(stage):
    """At the SUMMA's k = 3072 with a carried C_in far larger than one
    stage's partial (a late step), the route's arithmetic (a partial a ring
    stage, ``MMA_SLAB`` bytes of k; and one a k step) stays within
    chip_smoke.py's RTOL of the float64 result; and checked against the
    exact result's state by the reference's verify, it raises no alarm."""
    rs = np.random.RandomState(17)
    m, k, n, bm, bn = 256, 3072, 256, 128, 128
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    c_in = torch.from_numpy((1e3 * rs.standard_normal((m, n)))
                            .astype(np.float32))
    got = _acc_3xtf32(c_in, a, b, stage)
    ref = c_in.double() + a.double() @ b.double()
    assert within_rtol(got, ref)
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    exact = ref.float().numpy()
    state = jops.tile_checksums(jnp.asarray(exact), jnp.asarray(wm),
                                jnp.asarray(wn), bm, bn)
    _, stats = jops._tile_verify_correct(
        jnp.asarray(got.numpy()), state, jnp.asarray(wm), jnp.asarray(wn),
        bm, bn, tol_factor=64.0)
    stats = np.asarray(stats)
    assert not stats[..., 0].any() and not stats[..., 1].any()
    assert np.all(stats[..., 4] <= stats[..., 6])


def test_kernel_digest_follows_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ changes the library name, so the
    kernel is rebuilt; an unrelated header does not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int x = 1;\n")
    (tmp_path / "other.cuh").write_text("int y = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    d0 = build.source_digest("k")
    (tmp_path / "other.cuh").write_text("int y = 2;\n")
    assert build.source_digest("k") == d0
    (tmp_path / "b.cuh").write_text("int x = 2;\n")
    d1 = build.source_digest("k")
    assert d1 != d0
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edit\n')
    assert build.source_digest("k") not in (d0, d1)
    # the real sources: both kernels include the shared tile header and the
    # tensor-core helpers with the shared ring mainloop
    monkeypatch.undo()
    for name, headers in (("abft_matmul", {"abft_tile.cuh", "abft_mma.cuh"}),
                          ("abft_matmul_acc", {"abft_tile.cuh",
                                               "abft_mma.cuh"})):
        seen = set()
        build._local_includes((build.CSRC / f"{name}.cu").resolve(), seen)
        assert {p.name for p in seen} == {f"{name}.cu", *headers}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_acc_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py runs this comparison on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n, bm, bn in [(384, 256, 512, 128, 128), (200, 136, 328, 64, 64)]:
        if dtype == torch.int8:
            mk = lambda *s: torch.randint(-8, 9, s, generator=g,  # noqa
                                          device="cuda", dtype=torch.int8)
            out = torch.int32
        else:
            mk = lambda *s: torch.randn(s, generator=g,  # noqa: E731
                                        device="cuda").to(dtype)
            out = torch.float32
        a0, b0, a, b = mk(m, k), mk(k, n), mk(m, k), mk(k, n)
        wm = ops.kernel_weights(m, device="cuda")
        wn = ops.kernel_weights(n, device="cuda").T.contiguous()
        c0 = torch.zeros((m, n), dtype=out, device="cuda")
        st0 = (torch.zeros((-(-m // bm), 2, n), device="cuda"),
               torch.zeros((-(-n // bn), m, 2), device="cuda"))
        c1, ccol, crow, _ = kmm.abft_matmul_acc_cuda(a0, b0, c0, *st0, wm, wn,
                                                     bm=bm, bn=bn)
        got = kmm.abft_matmul_acc_cuda(a, b, c1, ccol, crow, wm, wn, bm=bm,
                                       bn=bn)
        want = kmm.abft_matmul_acc_plain(a, b, c1, ccol, crow, wm, wn, bm=bm,
                                         bn=bn)
        torch.cuda.synchronize()
        assert float(got[3][..., 4:6].abs().max()) == 0.0
        torch.testing.assert_close(got[3][..., :4], want[3][..., :4])
        if dtype == torch.int8:
            assert torch.equal(got[0], want[0])
        assert_close(got[0], want[0])
        scale = _state_scale(to_np(want[0]))
        for x, y in zip(got[1:3], want[1:3]):
            assert_close(x, y, scale=scale)

"""The port's fused dual-checksum matmul against the JAX reference.

On this CPU the port's dispatch runs the kernel's plain PyTorch version
(the wrapper takes it only for CPU tensors); the reference runs its Pallas
kernel in interpret mode.  The CUDA kernel itself is held against the plain
version on the card by the ``gpu``-marked test at the end and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.abft_matmul import abft_matmul_pallas
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from torch_port_helpers import (assert_close, product_3xtf32, tf32, to_np,
                                to_torch, within_rtol)

SHAPES = [(130, 200, 70), (256, 384, 256)]


@pytest.fixture(autouse=True)
def _cost_model_plans(monkeypatch):
    # the reference's dispatcher reads an on-disk autotune cache when warm;
    # hold it to the pure cost model so both runs are reproducible
    monkeypatch.setenv("REPRO_AUTOTUNE_DISABLE", "1")


def _residual_wn(n_enc, f=2):
    """wn = [w_r; -I], the weights core.abft_gemm feeds the kernel."""
    from repro_torch.core.abft_gemm import _weights
    wr = _weights(n_enc - f, f, 17).numpy()
    return np.concatenate([wr, -np.eye(f, dtype=np.float32)], axis=0)


def _checksum_scales(c, wm, wn):
    """Largest term magnitude of each checksum sum: the residual direction
    cancels terms of that size, so its tolerance scales with them."""
    c = np.abs(np.asarray(to_np(c), np.float64))
    return (float(np.max(np.abs(wm) @ c)), float(np.max(c @ np.abs(wn))))


@pytest.mark.parametrize("m", [4, 1000, 4096])
def test_kernel_weights_bit_identical(m):
    got = ops.kernel_weights(m).numpy()
    want = np.array(jops.kernel_weights(m))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("weights", ["default", "residual"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_abft_matmul_matches_reference(rs, m, k, n, dtype, weights):
    """Port ops.abft_matmul (kernel dispatch) == JAX ops.abft_matmul
    (Pallas, interpret mode) == JAX ref == the port's ref.  bf16 operands produce fp32 out,
    as on the serving path; both accumulate in fp32."""
    a_np = rs.standard_normal((m, k)).astype(np.float32)
    b_np = rs.standard_normal((k, n)).astype(np.float32)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    a_j, b_j = jnp.asarray(a_np, jdt), jnp.asarray(b_np, jdt)
    a_t, b_t = to_torch(a_j, tdt), to_torch(b_j, tdt)
    wm = np.array(jops.kernel_weights(m))
    wn = (np.array(jops.kernel_weights(n)).T if weights == "default"
          else _residual_wn(n))
    before = kmm.plain_calls
    c_t, col_t, row_t = ops.abft_matmul(
        a_t, b_t, wm=torch.from_numpy(wm), wn=torch.from_numpy(wn),
        out_dtype=torch.float32)
    assert kmm.plain_calls == before + 1
    c_p, col_p, row_p = ref.abft_matmul_ref(
        a_t, b_t, torch.from_numpy(wm), torch.from_numpy(wn),
        out_dtype=torch.float32)
    c_j, col_j, row_j = jops.abft_matmul(
        a_j, b_j, wm=jnp.asarray(wm), wn=jnp.asarray(wn),
        out_dtype=jnp.float32, force_pallas=True, max_waste=float("inf"))
    c_r, col_r, row_r = jref.abft_matmul_ref(
        a_j, b_j, jnp.asarray(wm), jnp.asarray(wn), out_dtype=jnp.float32)
    s_col, s_row = _checksum_scales(c_r, wm, wn)
    for want_c, want_col, want_row in ((c_j, col_j, row_j),
                                      (c_r, col_r, row_r),
                                      (c_p, col_p, row_p)):
        assert_close(c_t, want_c)
        assert_close(col_t, want_col, scale=s_col)
        assert_close(row_t, want_row, scale=s_row)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_product_is_bit_exact(rs, m, k, n):
    """int8 operands: c (int32) is bit-identical to the reference kernel's;
    the plain-sum checksum row sums integers below 2^24, so it is exact
    too; the Gaussian-weighted row is held to the fp32 tolerance."""
    a_np = rs.randint(-127, 128, size=(m, k)).astype(np.int8)
    b_np = rs.randint(-127, 128, size=(k, n)).astype(np.int8)
    c_t, col_t, row_t = ops.abft_matmul(
        torch.from_numpy(a_np), torch.from_numpy(b_np))
    c_j, col_j, row_j = jops.abft_matmul(
        jnp.asarray(a_np), jnp.asarray(b_np), force_pallas=True,
        max_waste=float("inf"))
    assert c_t.dtype == torch.int32
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(
        c_t.numpy().astype(np.int64),
        a_np.astype(np.int64) @ b_np.astype(np.int64))
    np.testing.assert_array_equal(col_t.numpy()[0], np.asarray(col_j)[0])
    np.testing.assert_array_equal(row_t.numpy()[:, 0], np.asarray(row_j)[:, 0])
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    s_col, s_row = _checksum_scales(c_t, wm, wn)
    assert_close(col_t, col_j, scale=s_col)
    assert_close(row_t, row_j, scale=s_row)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_per_tile_partials_match_pallas_layout(rs, dtype):
    """At the shared plan (128, 128, 128) the per-tile partials have the
    reference kernel's layout and values: ccol [m/bm, f, n], crow
    [n/bn, m, f]."""
    m, k, n = 256, 256, 384
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    a_j = jnp.asarray(rs.standard_normal((m, k)), jdt)
    b_j = jnp.asarray(rs.standard_normal((k, n)), jdt)
    wm = np.array(jops.kernel_weights(m))
    wn = np.array(jops.kernel_weights(n)).T
    c_j, col_j, row_j = abft_matmul_pallas(
        a_j, b_j, jnp.asarray(wm), jnp.asarray(wn), bm=128, bn=128, bk=128,
        interpret=True)
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    c_t, col_t, row_t = kmm.abft_matmul_cuda(
        to_torch(a_j, tdt), to_torch(b_j, tdt), torch.from_numpy(wm),
        torch.from_numpy(wn), bm=128, bn=128, bk=128)
    assert c_t.dtype == tdt
    assert tuple(col_t.shape) == col_j.shape == (2, 2, n)
    assert tuple(row_t.shape) == row_j.shape == (3, m, 2)
    # bf16 output: one rounding of an fp32 sum taken in another order may
    # land one bf16 ulp (2^-8 relative) apart, and each side's partials are
    # of its own rounded tile
    rtol = 1e-5 if dtype == "fp32" else 2 ** -8
    s_col, s_row = _checksum_scales(c_t, wm, wn)
    assert_close(c_t, c_j, rtol=rtol)
    assert_close(col_t, col_j, scale=s_col, rtol=rtol)
    assert_close(row_t, row_j, scale=s_row, rtol=rtol)


@pytest.mark.parametrize("bm,bn", [(16, 32), (32, 64), (128, 128)])
def test_ragged_partials_sum_to_weighted_checksums(rs, bm, bn):
    """Ragged shapes: the masked-edge partials of the plain version sum to
    W_m @ C and C @ W_n of its own output, at every built tile."""
    m, k, n = 37, 50, 70
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    wm, wn = ops.kernel_weights(m), ops.kernel_weights(n).T.contiguous()
    c, ccol, crow = kmm.abft_matmul_cuda(a, b, wm, wn, bm=bm, bn=bn)
    assert tuple(ccol.shape) == (-(-m // bm), 2, n)
    assert tuple(crow.shape) == (-(-n // bn), m, 2)
    assert_close(ccol.sum(0), wm @ c)
    assert_close(crow.sum(0), c @ wn)


def test_decode_shape_takes_the_kernel_at_any_padding(rs):
    """m = 4 on a 16-row tile pads 4x: the dispatcher still takes the
    kernel (its plain version on a CPU tensor), and publishes the dispatch
    of a new shape once, not once per call."""
    from repro_torch import obs
    m, k, n = 4, 64, 34
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    assert ops.pick_blocks(m, k, n).waste > 1.0
    traces = obs.counter("repro_kernel_traces_total")
    before_traces = traces.value(op="abft_matmul", backend="plain")
    before = kmm.plain_calls
    for _ in range(3):
        c, cs_col, cs_row = ops.abft_matmul(a, b)
    assert kmm.plain_calls == before + 3
    assert traces.value(op="abft_matmul", backend="plain") \
        <= before_traces + 1
    want = ref.abft_matmul_ref(a, b)
    for got, exp in zip((c, cs_col, cs_row), want):
        assert_close(got, exp)


SERVE_SHAPES = [(896, 898), (896, 130), (896, 4866), (4864, 898)]  # (k, n_enc)


def test_planner_covers_serving_shapes():
    """Every serving projection shape gets a plan kernel #1 is built for:
    a tensor-core tile within the dynamic shared-memory budget, or a
    split-k tile within the static one, whose k slices are all non-empty
    and at most ``SPLIT_KMAX`` rows; decode takes the split-k stream on
    the 16-row tile, prefill the tensor-core tiles."""
    for m in (4, 1024):
        for k, n in SERVE_SHAPES:
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                plan = ops.pick_blocks(m, k, n, in_dtype=dt)
                assert plan.route == kmm.route_of(plan.bm, plan.bn)
                assert plan.bk % kmm.KT == 0
                smem = ops.oneshot_smem_bytes(plan.bm, plan.bn, dt)
                if plan.route == "mma":
                    assert (plan.bm, plan.bn) in kmm.MMA_TILES
                    assert smem <= ops.SMEM_DYNAMIC and plan.splits == 1
                else:
                    assert plan.bm in kmm.SPLITK_TILES_M
                    assert smem <= ops.SMEM_STATIC
                    assert plan.splits == kmm.split_count(m, k, n,
                                                          ops.N_SM)
                    kslice = -(-k // plan.splits)
                    assert kslice <= kmm.SPLIT_KMAX
                    assert (plan.splits - 1) * kslice < k
                assert plan.pm >= m and plan.pn >= n and plan.pk >= k
                if m == 4:
                    assert plan.route == "splitk" and plan.bm == 16
                else:
                    assert plan.route == "mma"


@pytest.mark.parametrize("m", [4, 16, 1024, 2048])
def test_decode_takes_split_k_and_prefill_takes_tensor_cores(m):
    """m = 4 and 16 (decode slots) stream B in k slices; m = 1024 and 2048
    (prefill, a training step's batch x seq) take the tensor-core tiles, at
    every serving shape and operand type."""
    want = "splitk" if m <= 16 else "mma"
    for k, n in SERVE_SHAPES:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            assert ops.pick_blocks(m, k, n, in_dtype=dt,
                                   out_bytes=4).route == want


# kernel #2's plans (carry=True): the accumulate kernel, SUMMA and the chaos
# campaign plan through them: (bm, bn, bk, pm, pk, pn, cost_bytes, route),
# and the full ranking at the SUMMA step shape.  The SUMMA step keeps its
# 128 x 128 tile (so the carried state's layout) on the tensor-core route,
# whose k moves in ring stages of 256 bytes (bk 64 fp32, 128 bf16, 256
# int8); the campaign's 256^3 and the small SUMMA test blocks stay on
# CUDA-core tiles.
CARRY_PLANS = [
    ((3072, 3072, 3072), dict(in_dtype=torch.float32, out_bytes=4,
                              require_exact=True),
     (128, 128, 64, 3072, 3072, 3072, 1889814528, "mma")),
    ((3072, 3072, 3072), dict(in_dtype=torch.bfloat16, out_bytes=4,
                              require_exact=True),
     (128, 128, 128, 3072, 3072, 3072, 983844864, "mma")),
    ((3072, 3072, 3072), dict(in_dtype=torch.int8, out_bytes=4,
                              require_exact=True),
     (128, 128, 256, 3072, 3072, 3072, 530860032, "mma")),
    ((256, 256, 256), dict(require_exact=True),          # the campaign
     (32, 32, 16, 256, 256, 256, 4786176, "cuda_core")),
    ((128, 128, 128), dict(in_dtype=torch.float32, out_bytes=4,
                           require_exact=True),          # a SUMMA test block
     (16, 32, 16, 128, 128, 128, 943104, "cuda_core")),
    ((8, 8, 8), dict(), (16, 32, 16, 16, 16, 32, 1312, "cuda_core")),
    ((8, 8, 8), dict(require_exact=True), None),
    ((200, 136, 328), dict(), (32, 32, 16, 224, 144, 352, 3045024,
                               "cuda_core")),
]


@pytest.mark.parametrize("shape,kw,want", CARRY_PLANS)
def test_accumulate_plans_are_unchanged(shape, kw, want):
    plan = ops.pick_blocks(*shape, carry=True, **kw)
    got = None if plan is None else (plan.bm, plan.bn, plan.bk, plan.pm,
                                     plan.pk, plan.pn, plan.cost_bytes,
                                     plan.route)
    assert got == want
    if plan is not None:
        assert plan.route == kmm.route_of(plan.bm, plan.bn, carry=True)
        assert plan.splits == 1


def test_accumulate_rankings_are_unchanged():
    ranked = [(p.bm, p.bn, p.cost_bytes, p.route) for p in ops.rank_blocks(
        3072, 3072, 3072, in_dtype=torch.float32, out_bytes=4, carry=True,
        require_exact=True)]
    assert ranked == [
        (128, 128, 1889814528, "mma"), (128, 64, 2796982272, "mma"),
        (64, 128, 2796982272, "cuda_core"), (64, 64, 3704168448, "cuda_core"),
        (32, 128, 4611317760, "cuda_core"), (128, 32, 4611317760, "cuda_core"),
        (32, 64, 5518540800, "cuda_core"), (64, 32, 5518540800, "cuda_core"),
        (32, 32, 7332986880, "cuda_core"), (16, 128, 8239988736, "cuda_core"),
        (16, 64, 9147285504, "cuda_core"), (16, 32, 10961879040, "cuda_core")]
    ranked = [(p.bm, p.bn, p.cost_bytes) for p in ops.rank_blocks(
        256, 256, 256, carry=True, require_exact=True)]
    assert ranked == [
        (32, 32, 4786176), (16, 64, 5851136), (16, 32, 6918144),
        (32, 64, 3720192), (64, 32, 3720192), (16, 128, 5317632),
        (64, 64, 2654720), (32, 128, 3187200), (128, 32, 3187200),
        (64, 128, 2121984), (128, 64, 2121984), (128, 128, 1589376)]
    ranked = [(p.bm, p.bn, p.cost_bytes) for p in ops.rank_blocks(
        96, 64, 160, carry=True, require_exact=True)]
    assert ranked == [(16, 32, 515520), (32, 32, 384480)]


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0e-3], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2 ** -10          # a tie rounds away from zero
    assert got[2] == 1.0                     # under half an ulp: down
    assert got[3] == 1.0 + 2 ** -10          # over half an ulp: up
    assert got[4] == -(1.0 + 2 ** -10)
    lo = x - tf32(x)
    assert bool((lo.abs() <= 2 ** -11 * x.abs()).all())


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("k,n_enc", SERVE_SHAPES)
def test_3xtf32_product_holds_the_fp32_tolerance(m, k, n_enc):
    """The kernel's fp32 route: a 3xTF32 product of the served operands
    (x and an encoded weight) stays within chip_smoke.py's RTOL of the fp32
    product, and its fused-verify residual passes ``_residual_ok``."""
    from repro_torch.core import abft_gemm as ag
    rs = np.random.RandomState(m + k + n_enc)
    cfg = ag.ABFTConfig(mode="verify")
    n = n_enc - cfg.f
    x = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rs.standard_normal((k, n)) * k ** -0.5)
                         .astype(np.float32))
    w_enc = ag.encode_weight(w, cfg)
    y_f = product_3xtf32(x, w_enc)
    assert within_rtol(y_f, x @ w_enc)
    residual = y_f @ ag._residual_weights(n, cfg.f, cfg.seed, "cpu")
    assert bool(ag._residual_ok(y_f[:, :n], residual, cfg))


def test_one_tf32_pass_misses_the_fp32_tolerance():
    """Why the split: one TF32 product (2^-11 a term) at the down
    projection's k = 4864 misses RTOL, where 3xTF32 holds it."""
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.standard_normal((64, 4864)).astype(np.float32))
    b = torch.from_numpy((rs.standard_normal((4864, 898)) * 4864 ** -0.5)
                         .astype(np.float32))
    ref = a @ b
    assert not within_rtol(tf32(a) @ tf32(b), ref)
    assert within_rtol(product_3xtf32(a, b), ref)


@pytest.mark.parametrize("m,k,n", [(4, 896, 898), (5, 900, 130),
                                   (16, 4864, 898), (4, 50, 70)])
def test_split_k_partials_summed_in_order_give_the_plain_layout(rs, m, k, n):
    """The split-k route's arithmetic in plain PyTorch: fp32 partials of
    ``split_count`` k slices, summed in split order, then the epilogue's
    per-tile reduction of the stored tile (``ops.tile_checksums``), give
    the plain version's c / ccol / crow layout and values."""
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    wm = ops.kernel_weights(m)
    wn = ops.kernel_weights(n).T.contiguous()
    plan = ops.pick_blocks(m, k, n)
    assert plan.route == "splitk"
    splits = plan.splits
    assert splits == kmm.split_count(m, k, n, ops.N_SM)
    kslice = -(-k // splits)
    parts = [a[:, s * kslice:(s + 1) * kslice]
             @ b[s * kslice:(s + 1) * kslice] for s in range(splits)]
    assert all(p.shape == (m, n) for p in parts)
    assert 0 < k - (splits - 1) * kslice <= kslice <= kmm.SPLIT_KMAX
    c = parts[0].clone()
    for p in parts[1:]:
        c = c + p
    ccol, crow = ops.tile_checksums(c, wm, wn, plan.bm, plan.bn)
    c_p, ccol_p, crow_p = kmm.abft_matmul_plain(a, b, wm, wn, bm=plan.bm,
                                                bn=plan.bn)
    assert ccol.shape == ccol_p.shape and crow.shape == crow_p.shape
    s_col, s_row = _checksum_scales(c_p, wm.numpy(), wn.numpy())
    assert_close(c, c_p)
    assert_close(ccol, ccol_p, scale=s_col)
    assert_close(crow, crow_p, scale=s_row)


def test_detection_eps_matches_reference():
    for tdt, jdt in [(torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16),
                     (torch.int8, jnp.int8), (torch.int32, jnp.int32)]:
        assert ops.detection_eps(tdt) == jops.detection_eps(jdt)


def test_wrapper_raises_instead_of_falling_back(rs):
    """Only a CPU tensor gets the plain version: any other device launches
    the kernel or raises, and bad arguments raise before any launch."""
    a = torch.zeros((32, 16), device="meta")
    b = torch.zeros((16, 64), device="meta")
    wm = torch.zeros((2, 32), device="meta")
    wn = torch.zeros((64, 2), device="meta")
    launches, plain = kmm.launches, kmm.plain_calls
    with pytest.raises(RuntimeError):
        kmm.abft_matmul_cuda(a, b, wm, wn, bm=32, bn=64)
    cpu = lambda *s: torch.zeros(s)  # noqa: E731
    with pytest.raises(ValueError):     # tile not built
        kmm.abft_matmul_cuda(cpu(32, 16), cpu(16, 64), cpu(2, 32),
                             cpu(64, 2), bm=48, bn=64)
    with pytest.raises(ValueError):     # kernel #2's tile, not kernel #1's:
        kmm.abft_matmul_plain(cpu(32, 16), cpu(16, 64), cpu(2, 32),
                              cpu(64, 2), bm=64, bn=64)   # the plain refuses
    with pytest.raises(TypeError):      # int8 into a float output
        kmm.abft_matmul_cuda(cpu(32, 16).to(torch.int8),
                             cpu(16, 64).to(torch.int8), cpu(2, 32),
                             cpu(64, 2), bm=32, bn=64,
                             out_dtype=torch.float32)
    with pytest.raises(ValueError):     # too many checksum rows
        kmm.abft_matmul_cuda(cpu(32, 16), cpu(16, 64), cpu(5, 32),
                             cpu(64, 5), bm=32, bn=64)
    assert (kmm.launches, kmm.plain_calls) == (launches, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cuda_kernel_matches_plain_on_card(dtype):
    """Both routes (split-k at decode sizes, tensor-core tiles at prefill
    and training sizes), ragged shapes included, against the plain version;
    a repeated call is bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py runs this comparison on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    routes = set()
    for m, k, n in [(4, 896, 898), (16, 896, 4866), (1024, 896, 130),
                    (2048, 896, 898), (37, 50, 70), (5, 900, 130),
                    (1000, 900, 898)]:
        if dtype == torch.int8:
            a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                              dtype=torch.int8)
            b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                              dtype=torch.int8)
        else:
            a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
            b = torch.randn((k, n), generator=g, device="cuda").to(dtype)
        wm = ops.kernel_weights(m, device="cuda")
        wn = ops.kernel_weights(n, device="cuda").T.contiguous()
        plan = ops.pick_blocks(m, k, n, in_dtype=dtype)
        out = None if dtype == torch.int8 else torch.float32
        kw = dict(bm=plan.bm, bn=plan.bn, bk=plan.bk, out_dtype=out)
        got = kmm.abft_matmul_cuda(a, b, wm, wn, **kw)
        routes.add(kmm.last_route["route"])
        again = kmm.abft_matmul_cuda(a, b, wm, wn, **kw)
        want = kmm.abft_matmul_plain(a, b, wm, wn, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        if dtype == torch.int8:
            assert torch.equal(got[0], want[0])
        for x, y in zip(got, want):
            assert_close(x, y)
    assert routes == {"mma", "splitk"}

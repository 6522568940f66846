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
from torch_port_helpers import assert_close, to_np, to_torch

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


def test_planner_covers_serving_shapes():
    """Every serving projection shape gets a tile the kernel is built for,
    within the static shared-memory budget; decode takes the 16-row tile."""
    for m in (4, 1024):
        for k, n in [(896, 898), (896, 130), (896, 4866), (4864, 898)]:
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                plan = ops.pick_blocks(m, k, n, in_dtype=dt)
                assert plan.bm in kmm.TILES_M and plan.bn in kmm.TILES_N
                assert plan.bk % kmm.KT == 0
                assert ops.smem_bytes(plan.bm, plan.bn, plan.bk) \
                    <= ops.SMEM_STATIC
                assert plan.pm >= m and plan.pn >= n and plan.pk >= k
                if m == 4:
                    assert plan.bm == 16


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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py runs this comparison on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(4, 896, 898), (1024, 896, 130), (37, 50, 70)]:
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
        got = kmm.abft_matmul_cuda(a, b, wm, wn, bm=plan.bm, bn=plan.bn,
                                   out_dtype=out)
        want = kmm.abft_matmul_plain(a, b, wm, wn, bm=plan.bm, bn=plan.bn,
                                     out_dtype=out)
        torch.cuda.synchronize()
        if dtype == torch.int8:
            assert torch.equal(got[0], want[0])
        for x, y in zip(got, want):
            assert_close(x, y)

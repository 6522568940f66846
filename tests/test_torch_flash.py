"""The port's checked flash-attention forward (``repro_torch.kernels.
flash_attention``) held against the reference's Pallas kernel in interpret
mode, on the same numpy inputs.

On the CPU the wrapper runs the kernel's plain version (the reference's
online-softmax recurrence over ``bk`` chunks, inject included), so these
tests check that recurrence, the checked variant's residuals, detection
and dense repair.  The CUDA kernel itself is held against the plain
version on the card by the ``gpu``-marked test at the end and by
``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (FLASH_CHECK_TOL as J_TOL,
                                           flash_attention_checked as j_checked,
                                           flash_attention_pallas)
from repro_torch.kernels import flash_attention as F
from torch_port_helpers import flash_outside, product_3xtf32, tf32, to_np

# the reference's own cases (tests/test_flash_kernel.py)
CASES = [(True, None, None), (True, 384, None), (True, None, 50.0),
         (False, None, None), (True, 100, 30.0), (False, 100, None)]
BH, S, D = 2, 512, 64
# fp32: the same chunked recurrence, its matrix products summed in another
# order by another framework.  bf16 outputs: one bf16 ulp (2^-7 relative)
# on top of that, for an fp32 value that rounds the other way.
ATOL32 = 2e-6
RTOL16 = 8e-3


def _inputs(rs, dtype, sq=S, sk=S):
    a = [rs.standard_normal(shape).astype(np.float32)
         for shape in ((BH, sq, D), (BH, sk, D), (BH, sk, D))]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(x, jdt) for x in a],
            [torch.from_numpy(x).to(dtype) for x in a])


def _assert_out(got, want, dtype):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    rtol = 0.0 if dtype == torch.float32 else RTOL16
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL32)


def test_constants_match_reference():
    assert F.FLASH_CHECK_TOL == J_TOL == 1e-3
    assert F.NEG_INF == -1e30


@pytest.mark.parametrize("causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [(128, 128), (256, 128)])
def test_plain_matches_reference_kernel(rs, causal, window, softcap, dtype,
                                        blocks):
    bq, bk = blocks
    (jq, jk, jv), (q, k, v) = _inputs(rs, dtype)
    want = flash_attention_pallas(jq, jk, jv, scale=D ** -0.5, causal=causal,
                                  window=window, softcap=softcap, bq=bq,
                                  bk=bk, interpret=True)
    calls = F.plain_calls
    got = F.flash_attention_cuda(q, k, v, scale=D ** -0.5, causal=causal,
                                 window=window, softcap=softcap, bq=bq, bk=bk)
    assert F.plain_calls == calls + 1 and got.dtype == dtype
    _assert_out(got, want, dtype)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (False, 300)])
def test_rectangular_kv(rs, causal, window):
    """sq != sk, top-left aligned: q_pos is the global row and k_pos the
    global key; with a non-causal window and sq > sk, rows past the band
    see no key and store 0."""
    (jq, jk, jv), (q, k, v) = _inputs(rs, torch.float32, sq=1024, sk=256)
    kw = dict(scale=0.125, causal=causal, window=window, bq=128, bk=128)
    want = flash_attention_pallas(jq, jk, jv, interpret=True, **kw)
    got = F.flash_attention_plain(q, k, v, **kw)
    _assert_out(got, want, torch.float32)
    if window is not None:
        assert torch.all(got[:, 256 + window:] == 0)
    (jq, jk, jv), (q, k, v) = _inputs(rs, torch.float32, sq=256, sk=1024)
    kw["causal"] = False
    _assert_out(F.flash_attention_plain(q, k, v, **kw),
                flash_attention_pallas(jq, jk, jv, interpret=True, **kw),
                torch.float32)


def _report_matches(got, want):
    assert got.ok == want.ok
    assert got.detected == want.detected
    assert got.repaired == want.repaired
    for g, w in ((got.max_pv_residual, want.max_pv_residual),
                 (got.max_rowsum_residual, want.max_rowsum_residual)):
        if w > J_TOL or g > J_TOL:
            # a tripped residual is the fault's own size
            assert math.isinf(w) and math.isinf(g) or \
                abs(g - w) <= 1e-4 * abs(w), (g, w)
        else:
            assert g <= J_TOL and w <= J_TOL


@pytest.mark.parametrize("causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checked_clean_flags_nothing(rs, causal, window, softcap, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(rs, dtype)
    kw = dict(scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, bq=128, bk=128)
    jo, jrep = j_checked(jq, jk, jv, interpret=True, **kw)
    o, rep = F.flash_attention_checked(q, k, v, **kw)
    assert rep.ok and rep.repaired == 0 and rep.detected == ()
    _report_matches(rep, jrep)
    _assert_out(o, jo, dtype)
    # the checked run's output is the unchecked one's
    torch.testing.assert_close(o, F.flash_attention_plain(q, k, v, **kw),
                               rtol=0, atol=0)


# (qi, kk) with bq = bk = 128, causal: kk < qi before the diagonal, kk = qi
# on it, kk > qi past it (a chunk every key of which the tile masks)
INJECTS = [(2, 0), (1, 1), (1, 2), (0, 3)]


@pytest.mark.parametrize("target", ["acc", "l"])
@pytest.mark.parametrize("qi,kk", INJECTS)
def test_inject_detected_and_repaired_like_reference(rs, target, qi, kk):
    (jq, jk, jv), (q, k, v) = _inputs(rs, torch.float32)
    kw = dict(scale=D ** -0.5, causal=True, bq=128, bk=128)
    inject = (qi, kk, 1e4, target)
    jo, jrep = j_checked(jq, jk, jv, interpret=True, inject=inject, **kw)
    o, rep = F.flash_attention_checked(q, k, v, inject=inject, **kw)
    assert rep.detected == ((0, qi),) and rep.repaired == 1
    _report_matches(rep, jrep)
    np.testing.assert_allclose(to_np(o), to_np(jo), rtol=0, atol=2e-5)
    clean = F.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(to_np(o), to_np(clean), rtol=0, atol=2e-5)


def test_inject_into_a_leading_masked_chunk_is_absorbed_like_reference(rs):
    """A two-sided window puts fully masked chunks first in kk order.  A
    delta folded into the state before the row's first live key is scaled
    away by that key's corr = exp(NEG_INF - m) = 0, in the reference as in
    the port: nothing trips and the output is the clean one."""
    (jq, jk, jv), (q, k, v) = _inputs(rs, torch.float32)
    kw = dict(scale=D ** -0.5, causal=True, window=100, bq=128, bk=128)
    clean = F.flash_attention_plain(q, k, v, **kw)
    for target in ("acc", "l"):
        inject = (3, 0, 1e4, target)
        jo, jrep = j_checked(jq, jk, jv, interpret=True, inject=inject, **kw)
        o, rep = F.flash_attention_checked(q, k, v, inject=inject, **kw)
        assert rep.detected == jrep.detected == ()
        _report_matches(rep, jrep)
        torch.testing.assert_close(o, clean, rtol=0, atol=0)
        np.testing.assert_allclose(to_np(o), to_np(jo), rtol=0, atol=ATOL32)


def test_nan_inject_into_acc_is_flagged(rs):
    (jq, jk, jv), (q, k, v) = _inputs(rs, torch.float32)
    kw = dict(scale=D ** -0.5, causal=True, bq=128, bk=128)
    inject = (1, 0, float("nan"), "acc")
    jo, jrep = j_checked(jq, jk, jv, interpret=True, inject=inject, **kw)
    o, rep = F.flash_attention_checked(q, k, v, inject=inject, **kw)
    assert rep.detected == jrep.detected == ((0, 1),)
    assert math.isinf(rep.max_pv_residual)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(to_np(o), to_np(jo), rtol=0, atol=2e-5)


@pytest.mark.parametrize("delta", [float("nan"), -1e4])
@pytest.mark.parametrize("kk", [0, 1, 3])
def test_l_fault_that_kills_l_is_flagged_unlike_reference(kk, delta):
    """An ``l`` inject that leaves ``l`` NaN or negative.  The reference
    reads such a row as having no live key (``live = l > 0``) and flags
    nothing; the port decides liveness from the duplicate row sum ``l2``
    and reads the dead ``l`` as a trip: it flags tile (0, 1) and repairs it
    to the clean output within the reference's own margin for the -1
    inject it does catch (1e-6).  This is where the port departs from the
    reference."""
    rs = np.random.RandomState(0)
    a = [rs.standard_normal((2, 256, D)).astype(np.float32)
         for _ in range(3)]
    jq, jk, jv = (jnp.asarray(x) for x in a)
    q, k, v = (torch.from_numpy(x) for x in a)
    kw = dict(scale=D ** -0.5, causal=True, bq=64, bk=64)
    inject = (1, kk, delta, "l")
    _, jrep = j_checked(jq, jk, jv, interpret=True, inject=inject, **kw)
    assert jrep.detected == ()
    o, rep = F.flash_attention_checked(q, k, v, inject=inject, **kw)
    assert rep.detected == ((0, 1),) and rep.repaired == 1
    assert math.isinf(rep.max_rowsum_residual) \
        or math.isnan(rep.max_rowsum_residual)
    clean = F.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(o).all()
    assert float((o - clean).abs().max()) <= 1e-6


def test_stats_shape_and_block_contract(rs):
    _, (q, k, v) = _inputs(rs, torch.float32)
    o, stats = F.flash_attention_plain(q, k, v, scale=0.125, bq=128, bk=256,
                                       checksum=True)
    assert o.shape == q.shape and stats.shape == (BH, S // 128, 2)
    assert stats.dtype == torch.float32
    for bq, bk in ((96, 128), (128, 100)):
        with pytest.raises(ValueError):
            F.flash_attention_cuda(q, k, v, scale=0.125, bq=bq, bk=bk)
        with pytest.raises(ValueError):
            F.flash_attention_checked(q, k, v, scale=0.125, bq=bq, bk=bk)
    with pytest.raises(ValueError):
        F.flash_attention_plain(q, k, v, scale=0.125, bq=128, bk=128,
                                checksum=True, inject=(4, 0, 1.0, "acc"))
    with pytest.raises(TypeError):
        F.flash_attention_plain(q.double(), k.double(), v.double(),
                                scale=0.125)


# ---- the CUDA kernel's arithmetic, as a plain-PyTorch twin ---------------
#
# The kernel (csrc/flash_attention.cu) runs QK^T and P.V on tensor cores:
# fp32 operands through 3xTF32 (x = hi + lo, each rounded to TF32, the small
# terms first), bf16 QK^T straight from bf16 Q and K with fp32 sums and P
# split into bf16 hi + lo against exact bf16 V; each chunk's fp32 P.V is
# summed from zero and added to acc in fp32; the checksums ride P.V as
# the column tile [vsum_hi, vsum_lo, 1] of V in the operand type.  The
# twin below repeats that arithmetic with exact fp32 sums (the order of a
# sum over keys or d is the tensor core's own) and is held to
# flash_attention_plain under chip_smoke.py's flash_close at 2 x 1024 x 64.

TWIN_BH, TWIN_S = 2, 1024
TWIN_CASES = {"causal": dict(causal=True, window=None, softcap=None),
              "window+softcap": dict(causal=True, window=256, softcap=50.0)}


def _twin_inputs(dtype, seed=0):
    rs = np.random.RandomState(seed)
    a = [rs.standard_normal((TWIN_BH, TWIN_S, D)).astype(np.float32)
         for _ in range(3)]
    return a, [torch.from_numpy(x).to(dtype) for x in a]


def _split_bf16(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _twin_product(a, b, how):
    """a @ b for fp32 operands as the kernel's tensor core forms it."""
    if how == "3xtf32":
        return product_3xtf32(a, b)
    return tf32(a) @ tf32(b)                 # one TF32 pass


def flash_twin(q, k, v, *, scale, causal, window, softcap, bc=64, bq=256,
               qk="3xtf32", pv="3xtf32", p_bf16="split"):
    """The kernel's forward on CPU tensors: ``(o, stats, cs, l2)`` with
    stats [BH, Sq // bq, 2] as flash_attention_plain's.  fp32: ``qk`` and
    ``pv`` are "3xtf32" or "tf32"; bf16: ``p_bf16`` is "split" (hi + lo)
    or "single" (one bf16 rounding of P)."""
    f32 = q.dtype == torch.float32
    bh, sq, d = q.shape
    sk = k.shape[1]
    q32, k32, v32 = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), F.NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    aug = torch.zeros((bh, sq, 3))           # columns vsum_hi, vsum_lo, 1
    q_pos = torch.arange(sq)[:, None]
    for c0 in range(0, sk, bc):
        kc, vc = k32[:, c0:c0 + bc], v32[:, c0:c0 + bc]
        kt = kc.transpose(1, 2)
        s = (_twin_product(q32, kt, qk) if f32 else q32 @ kt) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = F._mask(q_pos, c0 + torch.arange(kc.shape[1])[None, :],
                       causal, window)
        s = torch.where(mask, s, F.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        vsum = vc.sum(-1, keepdim=True)
        if f32:
            vh = tf32(vsum)
            cols = torch.cat([vh, tf32(vsum - vh), torch.ones_like(vh)], -1)
            part = _twin_product(p, vc, pv)
            # B = cols is exact in TF32: the split P's two terms
            ph = tf32(p)
            apart = tf32(p - ph) @ cols + ph @ cols
        else:
            vh, vl = _split_bf16(vsum)
            cols = torch.cat([vh, vl, torch.ones_like(vh)], -1)
            if p_bf16 == "split":
                ph, pl = _split_bf16(p)
                part, apart = pl @ vc + ph @ vc, pl @ cols + ph @ cols
            else:
                ph = p.to(torch.bfloat16).float()
                part, apart = ph @ vc, ph @ cols
        acc = acc * corr + part
        aug = aug * corr + apart
    l_safe = torch.clamp_min(l, 1e-30)
    o = acc / l_safe
    cs, l2 = aug[..., :1] + aug[..., 1:2], aug[..., 2:]
    live = l2 > 0.0
    want = cs / l_safe
    r_pv = torch.where(live, (o.sum(-1, keepdim=True) - want).abs()
                       / (want.abs() + 1.0), 0.0)
    r_l = torch.where(live, (l2 / l_safe - 1.0).abs(), 0.0)
    rows = torch.cat([r_pv, r_l], -1)
    stats = rows.view(bh, sq // bq, bq, 2).amax(2)
    return o.to(q.dtype), stats, cs, l2


def _twin_vs_plain(dtype, case, **how):
    _, (q, k, v) = _twin_inputs(dtype)
    kw = dict(scale=D ** -0.5, **TWIN_CASES[case])
    o, stats, _, _ = flash_twin(q, k, v, **kw, **how)
    want = F.flash_attention_plain(q, k, v, bq=256, bk=256, **kw)
    return flash_outside(o, want, dtype), o, want, stats


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_plain_matches_reference_kernel_at_twin_size(case):
    """The yardstick of the twin tests: flash_attention_plain against the
    reference's interpret-mode kernel on the same 2 x 1024 x 64 inputs."""
    a, (q, k, v) = _twin_inputs(torch.float32)
    kw = dict(scale=D ** -0.5, bq=256, bk=256, **TWIN_CASES[case])
    want = flash_attention_pallas(*(jnp.asarray(x) for x in a),
                                  interpret=True, **kw)
    _assert_out(F.flash_attention_plain(q, k, v, **kw), want, torch.float32)


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_3xtf32_both_products_within_rtol(case):
    outside, o, want, _ = _twin_vs_plain(torch.float32, case)
    assert outside == 0
    assert float((o - want).abs().max()) < 5e-6


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_bf16_split_p_within_one_ulp(case):
    outside, o, want, _ = _twin_vs_plain(torch.bfloat16, case)
    assert outside == 0 and o.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_checksum_columns_give_clean_residuals(dtype, case):
    """cs and l2 out of the augmented V column tile: clean residuals (r_l
    = |l2 / l - 1| and r_pv) well under FLASH_CHECK_TOL, and cs / l2, the
    p-weighted mean of vsum, within 1e-4 of max |vsum| of its float64
    value."""
    _, (q, k, v) = _twin_inputs(dtype)
    kw = dict(scale=D ** -0.5, **TWIN_CASES[case])
    _, stats, cs, l2 = flash_twin(q, k, v, **kw)
    assert float(stats.max()) < F.FLASH_CHECK_TOL / 10
    # the same sums in float64 from the plain recurrence's own state
    s = (q.double() @ k.double().transpose(1, 2)) * kw["scale"]
    if kw["softcap"]:
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    mask = F._mask(torch.arange(TWIN_S)[:, None],
                   torch.arange(TWIN_S)[None, :], kw["causal"], kw["window"])
    s = torch.where(mask, s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    vsum = v.double().sum(-1, keepdim=True)
    ref_cs, ref_l = p @ vsum, p.sum(-1, keepdim=True)
    # the running state carries exp(m_final - m_row) against the float64
    # sums: compare the ratios the epilogue reads
    assert torch.allclose(cs.double() / l2.double(), ref_cs / ref_l,
                          rtol=0, atol=1e-4 * float(vsum.abs().max()))


@pytest.mark.parametrize("product", ["qk", "pv"])
def test_one_tf32_pass_in_either_product_misses_rtol(product):
    """One TF32 pass (10-bit mantissas) in QK^T or in P.V leaves tens of
    thousands of the 131,072 outputs outside RTOL (37,446 for QK^T and
    34,905 for P.V on these inputs; 55,835 with both), which is what put
    both fp32 products on 3xTF32."""
    how = {product: "tf32"}
    outside, _, _, _ = _twin_vs_plain(torch.float32, "causal", **how)
    assert outside > 25_000, outside


def test_one_bf16_rounding_of_p_misses_one_ulp():
    """P rounded once to bf16 against exact bf16 V leaves thousands of the
    outputs outside one bf16 ulp (11,852 of 131,072 on these inputs); hi +
    lo (test above) leaves none."""
    outside, _, _, _ = _twin_vs_plain(torch.bfloat16, "causal",
                                      p_bf16="single")
    assert outside > 8_000, outside


def test_tile_table_matches_the_kernels():
    """tile_of mirrors csrc/flash_attention.cu's Cfg (the wrapper checks
    the launch's reported tile against it)."""
    got = {(d, str(dt)[6:]): F.tile_of(d, dt) for d in F.HEAD_DIMS
           for dt in (torch.float32, torch.bfloat16)}
    assert got == {(64, "float32"): (128, 64), (64, "bfloat16"): (64, 64),
                   (128, "float32"): (64, 32), (128, "bfloat16"): (64, 64),
                   (256, "float32"): (64, 16), (256, "bfloat16"): (128, 32)}


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU "
                    "mode (chip_smoke.py runs this comparison on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(0)
    for causal, window, softcap in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rs.standard_normal((BH, S, D))
                                        .astype(np.float32))
                       .to("cuda", dtype) for _ in range(3))
            kw = dict(scale=D ** -0.5, causal=causal, window=window,
                      softcap=softcap, bq=128, bk=128, checksum=True)
            launches = F.launches
            o, st = F.flash_attention_cuda(q, k, v, **kw)
            po, pst = F.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            assert F.launches == launches + 1
            # the tensor-core route on the tile the wrapper planned
            assert F.last_route["route"] == "mma"
            assert F.last_route["tile"] == F.tile_of(D, dtype)
            _assert_out(o.cpu(), po.cpu(), dtype)
            assert float(st.max()) <= F.FLASH_CHECK_TOL
            o, rep = F.flash_attention_checked(
                q, k, v, scale=D ** -0.5, causal=causal, window=window,
                softcap=softcap, bq=128, bk=128, inject=(1, 2, 1e4, "l"))
            assert rep.detected == ((0, 1),)

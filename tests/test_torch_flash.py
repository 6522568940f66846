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
from torch_port_helpers import to_np

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
            _assert_out(o.cpu(), po.cpu(), dtype)
            assert float(st.max()) <= F.FLASH_CHECK_TOL
            o, rep = F.flash_attention_checked(
                q, k, v, scale=D ** -0.5, causal=causal, window=window,
                softcap=softcap, bq=128, bk=128, inject=(1, 2, 1e4, "l"))
            assert rep.detected == ((0, 1),)

"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference: the same numpy inputs go to both packages, and the outputs come
back as numpy arrays."""
import numpy as np
import torch

# fp32 sums run in another order in the two frameworks, so agreement is to
# a few fp32 ulps of the largest term, not bit for bit
RTOL = 1e-5


def to_np(x):
    """A JAX array or a torch tensor -> float64 / integer numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_torch(x, dtype=None):
    """A numpy (or JAX) array -> CPU tensor, keeping bf16."""
    t = torch.from_numpy(np.array(to_np(x)))
    return t.to(dtype) if dtype is not None else t


def assert_close(got, want, *, scale=None, rtol=RTOL):
    """|got - want| <= rtol * |want| + rtol * scale, scale = max|want| by
    default (the fp32 tolerance of tests/test_abft_gemm.py)."""
    got = np.asarray(to_np(got), np.float64)
    want = np.asarray(to_np(want), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scale is None:
        scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale + 1e-30)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), nearest with ties away from zero:
    half a TF32 ulp added to the bits, the 13 low mantissa bits cleared
    (the kernels' ``abft_mma.cuh::tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product_3xtf32(a, b):
    """The kernels' 3xTF32 product in plain fp32: a = a_hi + a_lo and
    b = b_hi + b_lo, each part rounded to TF32, the small terms first."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def within_rtol(x, ref):
    """chip_smoke.py's criterion: |x - ref| <= RTOL (|ref| + max|ref|)."""
    x, ref = x.double(), ref.double()
    tol = RTOL * ref.abs() + RTOL * float(ref.abs().max())
    return bool(((x - ref).abs() <= tol).all())


BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative


def flash_outside(x, ref, dtype) -> int:
    """Elements of ``x`` outside chip_smoke.py's ``flash_close`` of ``ref``:
    fp32 within RTOL (relative, plus RTOL of the largest |ref|); bf16
    within one bf16 ulp of ref on top of that."""
    x, ref = x.double(), ref.double()
    rel = RTOL if dtype == torch.float32 else BF16_ULP
    scale = float(ref.abs().max())
    return int((~((x - ref).abs() <= rel * ref.abs() + RTOL * scale)).sum())

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

"""Plain PyTorch oracles for the kernels (the correctness ground truth)."""
from __future__ import annotations

import functools

import torch

from repro_torch.core.checksum import checkpoint_matrix

__all__ = ["default_weights", "abft_matmul_ref", "checksum_encode_ref",
           "checksum_verify_ref"]

# Seed for the kernel-level checkpoint matrices.  Fixed so that carried
# checksum states are reproducible across calls, processes and the two
# packages (row/col 0 is the plain Huang-Abraham sum either way).
_WEIGHT_SEED = 23


@functools.lru_cache(maxsize=512)
def _default_weights(m: int, f: int, dtype, device: str) -> torch.Tensor:
    return checkpoint_matrix(f, m, seed=_WEIGHT_SEED, dtype=dtype,
                             device=device)


def default_weights(m: int, f: int = 2, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """The kernel's [f, m] checksum weights (row 0 = plain sum-checksum).

    Cached per (m, f, dtype, device): callers must not write into it."""
    return _default_weights(m, f, dtype, str(torch.device(device or "cpu")))


def abft_matmul_ref(a: torch.Tensor, b: torch.Tensor, wm=None, wn=None, *,
                    f: int = 2, out_dtype=None):
    """C = A @ B plus its dual weighted checksums (fp32 accumulation).

    wm: [f, m] (default ``default_weights(m, f)``), wn: [n, f] (default
    ``default_weights(n, f).T``).  Returns (c: [m, n] in out_dtype,
    cs_col = wm @ C: [f, n] fp32, cs_row = C @ wn: [m, f] fp32), where the
    checksums are computed from the ROUNDED output — exactly what the fused
    kernel reduces from its accumulator in the epilogue.
    """
    m, n = a.shape[0], b.shape[1]
    out_dtype = out_dtype or a.dtype
    wm = default_weights(m, f, device=a.device) if wm is None else wm
    wn = default_weights(n, f, device=a.device).T if wn is None else wn
    c32 = torch.matmul(a.float(), b.float())
    c = c32.to(out_dtype)
    rounded = c.float()
    cs_col = torch.matmul(wm.float(), rounded)
    cs_row = torch.matmul(rounded, wn.float())
    return c, cs_col, cs_row


def checksum_encode_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Weighted checksums of stacked shards: [p, m, n] x [f, p] -> [f, m, n]
    (fp32 sums, rounded once to x.dtype)."""
    return torch.einsum("fp,pmn->fmn", a.float(), x.float()).to(x.dtype)


def checksum_verify_ref(c: torch.Tensor, colsum: torch.Tensor) -> torch.Tensor:
    """Max abs residual between colsum(C) and a carried checksum row."""
    rec = torch.sum(c.float(), dim=0)
    return torch.max(torch.abs(rec - colsum.float()))

"""Bit-flip detection / location / correction on encoded products (paper §1, §2.2).

Consistency of a fully-encoded C_F at block granularity:

    sum_i cc[j,i] * C_blockrow_i == CS_blockrow_j        (row relation)
    sum_i cr[j,i] * C_blockcol_i == CS_blockcol_j        (col relation)

A single corrupted element at global (r, c) breaks the row relation at
(r % mb, c) and the col relation at (r, c % nb); their intersection locates
it, and the sum-checksum residual (weights of row 0 are all ones) is exactly
the corruption delta.  Tolerance follows the paper's residual-check scaling
tau ~ tol_factor * n * eps * |C|, exactly as the reference package's
``repro/core/detect.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.encoding import EncodingSpec, block_views

__all__ = ["VerifyResult", "verify", "locate_and_correct", "residuals"]


class VerifyResult(NamedTuple):
    consistent: torch.Tensor      # bool scalar
    row_residual: torch.Tensor    # [f, mb, W]
    col_residual: torch.Tensor    # [H, f, nb]
    tol: torch.Tensor             # scalar threshold used


def residuals(c_f: torch.Tensor, spec: EncodingSpec):
    rows, cs_rows, cols, cs_cols = block_views(c_f, spec)
    row_res = (torch.einsum("fp,pmw->fmw", spec.cc.float(), rows.float())
               - cs_rows.float())
    col_res = (torch.einsum("fp,hpn->hfn", spec.cr.float(), cols.float())
               - cs_cols.float())
    return row_res, col_res


def verify(c_f: torch.Tensor, spec: EncodingSpec,
           tol_factor: float = 64.0) -> VerifyResult:
    """Check checksum consistency of an encoded matrix."""
    row_res, col_res = residuals(c_f, spec)
    n = c_f.shape[-1]
    eps = torch.finfo(torch.float32).eps \
        if c_f.dtype in (torch.float32, torch.float64) \
        else torch.finfo(torch.bfloat16).eps
    # mean-|.| scale: robust to the corrupted element inflating its own
    # tolerance (a max-scale lets a single huge flip mask itself)
    scale = c_f.float().abs().mean() + 1e-30
    tol = tol_factor * n * eps * scale
    bad = torch.maximum(row_res.abs().max(), col_res.abs().max())
    return VerifyResult(bad <= tol, row_res, col_res, tol)


def locate_and_correct(c_f: torch.Tensor, spec: EncodingSpec,
                       tol_factor: float = 64.0):
    """Detect, locate, and correct a single corrupted DATA element.

    Returns (corrected_c_f, was_corrupt, (row, col)).  Location uses the
    sum-checksum (j=0) residuals; the corruption delta is the row residual
    at the located position.  (Corruption inside a checksum block is
    detected too, but correction there is a recompute — see recovery.py.)
    """
    res = verify(c_f, spec, tol_factor)
    row_res, col_res = res.row_residual, res.col_residual
    w = c_f.shape[-1]
    nb = w // (spec.pc + spec.f)

    # row relation residual: [mb, W] -> (r % mb, c); argmax takes the
    # first maximum, as jnp.argmax does
    rr_flat = int(torch.argmax(row_res[0].abs()))
    rr, c = divmod(rr_flat, w)
    # col relation residual: [H, nb] -> (r, c % nb)
    cr_flat = int(torch.argmax(col_res[:, 0, :].abs()))
    r = cr_flat // nb

    delta = row_res[0, rr, c]
    was_corrupt = ~res.consistent
    corrected = c_f.clone()
    corrected[r, c] -= delta.to(c_f.dtype)
    corrected = torch.where(was_corrupt, corrected, c_f)
    return corrected, was_corrupt, (r, c)

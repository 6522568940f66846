"""Huang-Abraham matrix encodings (paper §2.2), at block (grid) granularity.

The paper distributes an m-by-n matrix over a pr-by-pc process grid and
extends it with f checksum *block* rows and columns:

    A_F = [[ A        , A_cs_cols ],        A_cs_rows[j] = sum_i cc[j,i] A_i
           [ A_cs_rows, corner    ]]        (A_i = i-th block row of A)

so the checksum blocks have the SAME block shape as data blocks and live on
the extra grid row/col.  The fundamental identity (Eq. 1):

    encode_block_rows(A) @ encode_block_cols(B) = encode_full(A @ B)

holds exactly in real arithmetic because the encodings are linear maps.
The sums run in fp32 and the result is cast back to the input dtype, as in
the reference package's ``repro/core/encoding.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.checksum import checkpoint_matrix

__all__ = [
    "EncodingSpec",
    "make_spec",
    "encode_block_rows",
    "encode_block_cols",
    "encode_full",
    "strip",
    "split_full",
    "block_views",
]


class EncodingSpec(NamedTuple):
    """Checksum weights at block granularity.

    cc: [f, pr]  weights over block-rows  (protects the m dimension)
    cr: [f, pc]  weights over block-cols  (protects the n dimension)
    """

    cc: torch.Tensor
    cr: torch.Tensor

    @property
    def f(self) -> int:
        return self.cc.shape[0]

    @property
    def pr(self) -> int:
        return self.cc.shape[1]

    @property
    def pc(self) -> int:
        return self.cr.shape[1]


def make_spec(f: int, pr: int, pc: int, seed: int = 0,
              device=None) -> EncodingSpec:
    return EncodingSpec(
        cc=checkpoint_matrix(f, pr, seed=seed, device=device),
        cr=checkpoint_matrix(f, pc, seed=seed + 1, device=device),
    )


def encode_block_rows(a: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """[..., pr*mb, K] -> [..., (pr+f)*mb, K]: append f checksum block-rows."""
    f, pr = cc.shape
    m, k = a.shape[-2], a.shape[-1]
    if m % pr:
        raise ValueError(f"rows {m} not divisible into pr={pr} blocks")
    mb = m // pr
    lead = tuple(a.shape[:-2])
    blocks = a.reshape(lead + (pr, mb, k))
    cs = torch.einsum("fp,...pmk->...fmk", cc.float(),
                      blocks.float()).to(a.dtype)
    out = torch.cat([blocks, cs], dim=-3)
    return out.reshape(lead + ((pr + f) * mb, k))


def encode_block_cols(b: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """[..., K, pc*nb] -> [..., K, (pc+f)*nb]: append f checksum block-cols."""
    f, pc = cr.shape
    k, n = b.shape[-2], b.shape[-1]
    if n % pc:
        raise ValueError(f"cols {n} not divisible into pc={pc} blocks")
    nb = n // pc
    lead = tuple(b.shape[:-2])
    blocks = b.reshape(lead + (k, pc, nb))
    cs = torch.einsum("fp,...kpn->...kfn", cr.float(),
                      blocks.float()).to(b.dtype)
    out = torch.cat([blocks, cs], dim=-2)
    return out.reshape(lead + (k, (pc + f) * nb))


def encode_full(a: torch.Tensor, spec: EncodingSpec) -> torch.Tensor:
    """Full encoding A_F: checksum block rows AND cols (incl. the corner)."""
    return encode_block_rows(encode_block_cols(a, spec.cr), spec.cc)


def strip(a_f: torch.Tensor, f_rows_elems: int = 0,
          f_cols_elems: int = 0) -> torch.Tensor:
    """Drop checksum extensions (given in ELEMENT counts: f*mb / f*nb)."""
    m = a_f.shape[-2] - f_rows_elems
    n = a_f.shape[-1] - f_cols_elems
    return a_f[..., :m, :n]


def block_views(c_f: torch.Tensor, spec: EncodingSpec):
    """Split an encoded matrix into block-stacked views.

    Returns (row_blocks, cs_row_blocks, col_blocks, cs_col_blocks) where
    row_blocks: [pr, mb, W], cs_row_blocks: [f, mb, W] over the full width W,
    col_blocks: [H, pc, nb], cs_col_blocks: [H, f, nb] over the full height H.
    """
    f, pr, pc = spec.f, spec.pr, spec.pc
    h, w = c_f.shape[-2], c_f.shape[-1]
    mb = h // (pr + f)
    nb = w // (pc + f)
    lead = tuple(c_f.shape[:-2])
    rows = c_f.reshape(lead + (pr + f, mb, w))
    cols = c_f.reshape(lead + (h, pc + f, nb))
    return (rows[..., :pr, :, :], rows[..., pr:, :, :],
            cols[..., :, :pc, :], cols[..., :, pc:, :])


def split_full(c_f: torch.Tensor, spec: EncodingSpec):
    """Split into (data, col_cs, row_cs, corner) element views."""
    f, pr, pc = spec.f, spec.pr, spec.pc
    h, w = c_f.shape[-2], c_f.shape[-1]
    mb = h // (pr + f)
    nb = w // (pc + f)
    m, n = pr * mb, pc * nb
    return (
        c_f[..., :m, :n],
        c_f[..., :m, n:],
        c_f[..., m:, :n],
        c_f[..., m:, n:],
    )

"""Erasure recovery for block-distributed encoded matrices (paper §2.1, §3.3).

Data model: a matrix is split into a [pr, pc] grid of blocks; checksum block
rows/cols (f of each) extend the grid to [pr+f, pc+f].  A *process failure*
erases one (or more) grid cells.  Recovery solves the per-column (or per-row)
weighted-checksum system exactly as `checksum.recover` does for vectors, on a
stacked block tensor [PR, PC, mb, nb].
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.checksum import recover
from repro_torch.core.encoding import EncodingSpec

__all__ = ["recover_blocks", "recoverable"]


def recoverable(failed: Sequence[Tuple[int, int]], pr: int, pc: int,
                f: int) -> bool:
    """Whether a failure set is recoverable: <= f failures per block column
    (recover along columns) OR <= f per block row.  The paper's single-failure
    case is always recoverable; general f needs the per-line bound."""
    by_col: dict = {}
    by_row: dict = {}
    for (r, c) in failed:
        by_col.setdefault(c, []).append(r)
        by_row.setdefault(r, []).append(c)
    col_ok = all(len(v) <= f for v in by_col.values())
    row_ok = all(len(v) <= f for v in by_row.values())
    return col_ok or row_ok


def _surviving(lost, p_data: int, f: int) -> list:
    """The checksum slots of a line whose cells were not lost: a lost
    checksum cell holds nothing usable, so the solve takes the others and
    the lost cell is refreshed from the restored data."""
    return [j for j in range(f) if p_data + j not in lost]


def recover_blocks(blocks: torch.Tensor, spec: EncodingSpec,
                   failed: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Rebuild erased grid cells of an encoded block tensor.

    blocks: [PR+f?, PC+f?, mb, nb] — either direction may carry its checksum
    extension; for each failed cell, the f checksum blocks along *some* axis
    must be intact.  failed: (row, col) grid coordinates whose data was lost
    (contents at those cells are ignored), checksum cells included: the
    solve uses the surviving checksum cells only, and every checksum cell of
    a recovered line is recomputed.  Returns a new tensor.
    """
    f = spec.f
    pr_tot, pc_tot = blocks.shape[0], blocks.shape[1]
    pr, pc = pr_tot - f, pc_tot - f  # data grid extent
    by_col: dict = {}
    by_row: dict = {}
    for (r, c) in failed:
        by_col.setdefault(c, []).append(r)
        by_row.setdefault(r, []).append(c)

    if all(len(v) <= f for v in by_col.values()) and pr_tot > pr:
        # recover along columns using the cc checksum rows
        out = blocks.clone()
        for c, rows in by_col.items():
            col = out[:, c]                               # [pr_tot, mb, nb]
            live = _surviving(rows, pr, f)
            fixed = recover(col[:pr], col[pr:][live], spec.cc[live],
                            [r for r in rows if r < pr])
            out[:pr, c] = fixed
            # refresh the checksum cells of this column too (consistency)
            out[pr:, c] = torch.einsum("fp,p...->f...", spec.cc.float(),
                                       fixed.float()).to(blocks.dtype)
        return out

    if all(len(v) <= f for v in by_row.values()) and pc_tot > pc:
        out = blocks.clone()
        for r, cols in by_row.items():
            row = out[r]                                  # [pc_tot, mb, nb]
            live = _surviving(cols, pc, f)
            fixed = recover(row[:pc], row[pc:][live], spec.cr[live],
                            [c for c in cols if c < pc])
            out[r, :pc] = fixed
            out[r, pc:] = torch.einsum("fp,p...->f...", spec.cr.float(),
                                       fixed.float()).to(blocks.dtype)
        return out

    raise ValueError(
        f"failure set {list(failed)} exceeds f={f} erasures per block line; "
        "not recoverable with this encoding")

"""Weighted-checksum algebra for f-failure encoding (paper §2.1).

A vector x is spread over p shards x_1..x_p.  To survive f failures we store
f weighted checksums  y_j = sum_i A[j,i] * x_i.  Any f-failure set is
recoverable iff the f-by-f submatrix A[:, failed] is nonsingular.

The checkpoint matrix is built with numpy's ``RandomState``, so it is
bit-identical to the reference package's
``repro/core/checksum.py::checkpoint_matrix`` for the same ``(f, p, seed)``.
``encode_pytree`` / ``recover_pytree`` apply the algebra to every leaf of a
tree (``repro_torch.tree``) whose leaves are stacked ``[p, ...]``.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["checkpoint_matrix", "encode", "recover", "encode_pytree",
           "recover_pytree"]


@functools.lru_cache(maxsize=256)
def _checkpoint_np(f: int, p: int, seed: int) -> np.ndarray:
    if f < 1:
        raise ValueError(f"need f >= 1 checksums, got {f}")
    if f > p:
        raise ValueError(f"cannot encode f={f} failures over p={p} shards")
    rng = np.random.RandomState(seed)
    a = rng.standard_normal((f, p))
    a[0, :] = 1.0
    # Scale Gaussian rows to O(1) column norms to keep cancellation mild.
    if f > 1:
        a[1:] /= np.sqrt(p)
        a[1:] += 1.0  # keep entries away from 0 (recoverability needs a_ji != 0)
    a.setflags(write=False)
    return a


def checkpoint_matrix(f: int, p: int, seed: int = 0, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """The f-by-p checkpoint matrix A (paper §2.1).

    Row 0 is all-ones so that the first checksum is the plain Huang-Abraham
    sum-checksum (needed for the ABFT consistency relation); remaining rows
    are Gaussian, giving well-conditioned f-by-f recovery systems w.h.p.
    """
    return torch.tensor(_checkpoint_np(f, p, seed), dtype=dtype,
                        device=device)


def encode(shards: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Encode stacked shards [p, ...] into checksums [f, ...]: y = A @ x."""
    p = shards.shape[0]
    if a.shape[1] != p:
        raise ValueError(f"checkpoint matrix is {tuple(a.shape)}, shards have "
                         f"p={p}")
    flat = shards.reshape(p, -1)
    y = torch.einsum("fp,pn->fn", a.to(shards.device, torch.float32),
                     flat.float())
    return y.reshape((a.shape[0],) + tuple(shards.shape[1:])).to(shards.dtype)


def recover(shards: torch.Tensor, checksums: torch.Tensor, a: torch.Tensor,
            failed: Sequence[int]) -> torch.Tensor:
    """Rebuild failed shards from survivors + checksums (paper §2.1).

    Solves  A[:, failed] @ x_failed = y - A[:, ok] @ x_ok  for the lost
    shards.  ``shards`` may hold anything at failed indices (it is ignored).
    Returns the full [p, ...] stack with failed entries restored.
    """
    failed = list(failed)
    f_used = len(failed)
    p = shards.shape[0]
    if f_used == 0:
        return shards
    if f_used > a.shape[0]:
        raise ValueError(f"{f_used} failures but only {a.shape[0]} checksums "
                         "available")
    ok = [i for i in range(p) if i not in failed]
    flat = shards.reshape(p, -1).float()
    y = checksums.reshape(checksums.shape[0], -1).float()
    a32 = a.to(shards.device, torch.float32)
    # the first f_used checksums (any f_used-subset works; these exist)
    rhs = y[:f_used] - a32[:f_used][:, ok] @ flat[ok]
    sub = a32[:f_used][:, failed]                    # f_used x f_used
    restored = flat.clone()
    restored[failed] = torch.linalg.solve(sub, rhs)
    return restored.reshape(shards.shape).to(shards.dtype)


# ----------------------------------------------------------------------------
# Tree variants: the diskless checkpoint of a full train state (§2.1 applied
# to every leaf).  The shard axis is leaf axis 0 (the data-parallel stack).
# ----------------------------------------------------------------------------


def encode_pytree(tree, a: torch.Tensor):
    """Checksum-encode every leaf of a [p, ...]-stacked tree."""
    return tree_map(lambda x: encode(x, a), tree)


def recover_pytree(tree, checksums, a: torch.Tensor, failed: Sequence[int]):
    """Recover the failed shard indices of every leaf from the checksum
    tree."""
    return tree_map(lambda x, y: recover(x, y, a, failed), tree, checksums)

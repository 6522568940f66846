"""Weighted-checksum algebra for f-failure encoding (paper §2.1).

Only the checkpoint matrix is ported so far.  It is built with numpy's
``RandomState``, so it is bit-identical to the reference package's
``repro/core/checksum.py::checkpoint_matrix`` for the same ``(f, p, seed)``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["checkpoint_matrix"]


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

"""Fault-tolerant context — the paper's ABFT BLAS framework (§4.1).

Tensors (or whole trees of them) are *registered* to the context;
registration checksum-encodes them across a shard axis.  When a failure
occurs, everything registered is recovered and the application continues —
"the code looks like a sequential code but the resulting application is
parallel and fault-tolerant".

Three encodings (paper §2.1/§4.1):
  * ``floating_point`` (default): weighted float checksums
    (`core.checksum`), which survive linear-algebra ops on the data and so
    enable ABFT.
  * ``gf256``: Reed-Solomon over GF(2^8) on the raw bytes
    (`core.galois`), any f; bit-exact recovery, no ABFT.
  * ``xor``: the f = 1 parity of the int32 bit patterns, classic diskless
    RAID; bit-exact recovery, no ABFT.

The counterpart of the reference package's ``repro/core/context.py``, on
tensors: every encode and recover runs on the leaves' device, and trees
are walked with `repro_torch.tree`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core import checksum as cs
from repro_torch.core.galois import gf_encode, gf_recover
from repro_torch.tree import tree_map

__all__ = ["FTContext"]


def _words(shards: torch.Tensor) -> torch.Tensor:
    if shards.element_size() != 4:
        raise TypeError(f"xor parity runs on 32-bit words, got "
                        f"{shards.dtype}")
    return shards.contiguous().view(torch.int32)


def _xor_encode(shards: torch.Tensor) -> torch.Tensor:
    bits = _words(shards)
    parity = bits[0].clone()
    for i in range(1, shards.shape[0]):
        parity ^= bits[i]
    return parity[None]


def _xor_recover(shards: torch.Tensor, parity: torch.Tensor,
                 failed: int) -> torch.Tensor:
    bits = _words(shards)
    acc = parity[0].clone()
    for i in range(shards.shape[0]):
        if i != failed:
            acc ^= bits[i]
    out = shards.clone()
    out[failed] = acc.view(shards.dtype)
    return out


def _poison(x: torch.Tensor, idx: Sequence[int], fill: float):
    out = x.clone()
    out[list(idx)] = fill
    return out


@dataclasses.dataclass
class _Entry:
    value: Any
    checksums: Any
    mode: str


class FTContext:
    """Registry of protected trees with encode / fail / recover lifecycle.

    Leaves must be stacked [p, ...] along the shard axis (axis 0).  The
    context is device-agnostic: it encodes and recovers on whatever device
    each leaf lies."""

    def __init__(self, p: int, f: int = 1, seed: int = 0):
        if f >= p:
            raise ValueError(f"need f < p, got f={f}, p={p}")
        self.p = p
        self.f = f
        self.a = cs.checkpoint_matrix(f, p, seed=seed)
        self._reg: Dict[str, _Entry] = {}

    # -- lifecycle -----------------------------------------------------------
    def register(self, name: str, tree, mode: str = "floating_point"):
        """Protect a tree; (re-)computes its checksums.

        Modes (paper §2.1/§4.1): `floating_point` (enables on-the-fly ABFT),
        `gf256` (bit-exact Reed-Solomon over GF(2^8), any f; rules out
        ABFT), `xor` (f=1 parity special case)."""
        if mode == "floating_point":
            enc = tree_map(lambda x: cs.encode(x, self.a), tree)
        elif mode == "gf256":
            enc = tree_map(lambda x: gf_encode(x, self.f), tree)
        elif mode == "xor":
            if self.f != 1:
                raise ValueError("xor parity supports f=1 only")
            enc = tree_map(_xor_encode, tree)
        else:
            raise ValueError(f"unknown encoding mode {mode!r}")
        self._reg[name] = _Entry(tree, enc, mode)

    def update(self, name: str, tree):
        """Refresh a registered value (re-encode)."""
        self.register(name, tree, self._reg[name].mode)

    def get(self, name: str):
        return self._reg[name].value

    # -- failure path --------------------------------------------------------
    def fail(self, indices: Sequence[int], corrupt_to: Optional[float] = None):
        """Simulate loss of shard `indices` on every registered value (the
        registered tensors are not written: each leaf is replaced)."""
        fill = float("nan") if corrupt_to is None else corrupt_to
        for entry in self._reg.values():
            entry.value = tree_map(lambda x: _poison(x, indices, fill),
                                   entry.value)

    def recover(self, indices: Sequence[int]):
        """Rebuild the failed shards of every registered value."""
        indices = list(indices)
        if len(indices) > self.f:
            raise ValueError(
                f"{len(indices)} failures exceed encoding capacity f={self.f}"
            )
        for entry in self._reg.values():
            if entry.mode == "floating_point":
                entry.value = tree_map(
                    lambda x, y: cs.recover(x, y, self.a, indices),
                    entry.value, entry.checksums)
            elif entry.mode == "gf256":
                # NaN poison is not byte-stable: zero the failed shards
                entry.value = tree_map(
                    lambda x, y: gf_recover(_poison(x, indices, 0), y,
                                            indices),
                    entry.value, entry.checksums)
            else:
                (failed,) = indices
                entry.value = tree_map(
                    lambda x, y: _xor_recover(x, y, failed),
                    entry.value, entry.checksums)

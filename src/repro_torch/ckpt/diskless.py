"""Diskless checkpointing of the train state: the paper's §2.1 applied to a
tree of stacked ``[p, ...]`` leaves.

The state is viewed as ``p`` logical shards along its leading axis; ``f``
weighted checksums are computed with the paper's checkpoint matrix (on a
pod their storage rotates over the same devices, so the cost is f/p of the
state, not dedicated processes).  At encode time the checkpoint keeps a
snapshot of every shard (the diskless protocol's 1x local memory) plus the
checksums.  On failure, survivors roll back to their snapshot and the lost
shards are solved from the checksums: a bounded rollback to the encode
point, with no disk in the loop.

Every floating leaf whose leading axis is ``p`` is encoded by
``kernels.ops.checksum_encode`` (kernel #3 on a CUDA tensor), viewed as
``[p, m, n]`` by `encode_view`: a 3-D leaf as it is, a leaf of rank 4 or
more as ``[p, shape[1], -1]``, a 2-D leaf as ``[p, 1, n]``, a 1-D one as
``[p, 1, 1]``.  That is the function the reference's einsum computes for the
leaves its Pallas gate turns away (m and n not multiples of 128, or rank
other than 3).  Other leaves are kept as they are.

Counterpart of the reference package's ``repro/ckpt/diskless.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.chaos.faults import register_surface
from repro_torch.core.checksum import checkpoint_matrix
from repro_torch.core.checksum import recover as _recover
from repro_torch.kernels import ops
from repro_torch.tree import keystr, tree_leaves, tree_leaves_with_path, \
    tree_map

__all__ = ["DisklessCheckpoint", "encode_view"]

# the protection domain this module owns: ERASURE of up to f known-failed DP
# shards.  Detection is the platform's job; the checksums recover, they do
# not detect.
register_surface(
    "ckpt.diskless/shards", owner=__name__, protected=True,
    promise="tolerance",
    detector="platform failure signal (simulated by FailureInjector); "
             "recovery solves the lost shards from the weighted checksums "
             "at the last encode point (bounded rollback)",
    kinds=("shard_loss",),
    note="the f x f checksum solve is float arithmetic: recovered shards "
         "are near-exact (bf16 leaves to about one bf16 ulp of the shard "
         "sum, since the checksum is stored in the leaf's type), survivors "
         "roll back bit-exactly to their snapshot")


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def encode_view(x: torch.Tensor, p: int) -> torch.Tensor:
    """The ``[p, m, n]`` view in which the encode takes a ``[p, ...]``
    leaf: 3-D as it is, rank 4 or more as ``[p, shape[1], -1]``, 2-D as
    ``[p, 1, n]``, 1-D as ``[p, 1, 1]``."""
    if x.dim() == 3:
        return x
    if x.dim() >= 4:
        return x.reshape(p, x.shape[1], -1)
    if x.dim() == 2:
        return x.reshape(p, 1, x.shape[1])
    return x.reshape(p, 1, 1)


class DisklessCheckpoint:
    def __init__(self, p: int, f: int = 1, seed: int = 0):
        self.p = p
        self.f = f
        self._seed = seed
        self.a = checkpoint_matrix(f, p, seed=seed)
        self._a_on: Dict[torch.device, torch.Tensor] = {}
        self._enc = None
        self._snapshot = None
        self._step = None

    def _matrix(self, device) -> torch.Tensor:
        a = self._a_on.get(device)
        if a is None:
            a = self._a_on[device] = self.a.to(device)
        return a

    def _encoded(self, x) -> bool:
        """Whether ``x`` is a leaf the checkpoint encodes (else it is kept
        as it is)."""
        return isinstance(x, torch.Tensor) and x.dim() >= 1 \
            and x.shape[0] == self.p and x.is_floating_point()

    # -- encode (the "checkpoint") -------------------------------------------
    def _enc_leaf(self, x):
        if not self._encoded(x):
            return x
        y = ops.checksum_encode(encode_view(x, self.p),
                                self._matrix(x.device))
        return y.reshape((self.f,) + tuple(x.shape[1:]))

    def encode(self, state, step: Optional[int] = None, *,
               owned: bool = False):
        """Snapshot + checksum every leaf over its leading [p, ...] axis.

        The snapshot is a copy that nothing else references: the live state
        may be updated in place after this call.  ``owned=True`` says the
        caller made ``state``'s tensors for this call and keeps no other
        reference to them (``ft.runtime.stack_view`` does), so they become
        the snapshot without a second copy."""
        self._snapshot = state if owned else tree_map(_clone, state)
        self._enc = tree_map(self._enc_leaf, self._snapshot)
        self._step = step
        return self._enc

    # -- scrub (at-rest integrity) --------------------------------------------
    def verify(self, state, tol: float = 1e-6):
        """Re-run the encode over ``state`` and compare against the held
        checksums: the at-rest scrubber's read side, meaningful only when
        ``state`` should be bit-identical to the encode-point state.
        Returns ``(ok, first_bad_leaf, max_residual)``, the residual of a
        leaf being ``max|new - held| / (max|held| + 1)`` (NaN counts as
        inf)."""
        if self._enc is None:
            raise RuntimeError("no diskless checkpoint taken")
        fresh = tree_map(self._enc_leaf, state)
        paths, resid = [], []
        for (path, ny), oy in zip(tree_leaves_with_path(fresh),
                                  tree_leaves(self._enc)):
            n32 = torch.as_tensor(ny).float()
            o32 = torch.as_tensor(oy).float().to(n32.device)
            resid.append(torch.max(torch.abs(n32 - o32))
                         / (torch.max(torch.abs(o32)) + 1.0))
            paths.append(path)
        # every leaf's residual comes to the host in one transfer
        dev = resid[0].device if resid else None
        values = torch.stack([r.to(dev) for r in resid]).cpu().tolist() \
            if resid else []
        bad, worst = "", 0.0
        for path, r in zip(paths, values):
            if math.isnan(r):
                r = math.inf
            if r > worst:
                worst = r
                if r > tol:
                    bad = keystr(path)
        return worst <= tol, bad, worst

    # -- recover ---------------------------------------------------------------
    def recover(self, damaged, failed: Sequence[int]):
        """Roll back to the last encode with `failed` shards rebuilt from the
        checksums.  `damaged` is not read (bounded rollback: its values are
        the post-failure state and are discarded).  Returns new tensors, so
        the snapshot survives for a later recovery."""
        if self._enc is None:
            raise RuntimeError("no diskless checkpoint taken")
        failed = list(failed)
        if len(failed) > self.f:
            raise ValueError(f"{len(failed)} failures > capacity f={self.f}")

        def fix(snap, y):
            if self._encoded(snap) and failed:
                # survivors roll back to their snapshot; failed shards are
                # solved from the checksums and the surviving snapshot shards
                return _recover(snap, y, self._matrix(snap.device), failed)
            return _clone(snap)

        return tree_map(fix, self._snapshot, self._enc)

    # -- elastic re-key --------------------------------------------------------
    def reshard(self, new_p: int,
                failed: Sequence[int] = ()) -> "DisklessCheckpoint":
        """Re-key the held checkpoint for a different shard count: recover
        the lost shards (at most f), re-split every floating ``[p, ...]``
        leaf of rank >= 2 to ``[new_p, ...]`` where ``new_p`` divides its
        global extent (else it is kept unstacked), and re-encode.  Returns a
        new `DisklessCheckpoint(new_p, f)` at the same step."""
        if self._snapshot is None:
            raise RuntimeError("no diskless checkpoint taken")
        state = self.recover(self._snapshot, list(failed))

        def resplit(x):
            if self._encoded(x) and x.dim() >= 2:
                glob = x.reshape((self.p * x.shape[1],) + tuple(x.shape[2:]))
                if glob.shape[0] % new_p == 0:
                    return glob.reshape(
                        (new_p, glob.shape[0] // new_p) + tuple(glob.shape[1:]))
                return glob
            return x

        fresh = DisklessCheckpoint(new_p, self.f, seed=self._seed)
        # `state` is recover's fresh copy: the new checkpoint may own it
        fresh.encode(tree_map(resplit, state), step=self._step, owned=True)
        return fresh

    def snapshot(self):
        """A copy of the held encode-point state (stacked ``[p, ...]``)."""
        if self._snapshot is None:
            raise RuntimeError("no diskless checkpoint taken")
        return tree_map(_clone, self._snapshot)

    @property
    def step(self):
        return self._step

    def memory_overhead(self) -> float:
        """f/p — the paper's 'more processors, cheaper fault tolerance'."""
        return self.f / self.p

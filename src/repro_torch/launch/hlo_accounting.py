"""Trip-count-aware cost accounting of a step, by dispatch.

The reference parses a compiled program's HLO and walks its loops with
their trip counts, because XLA's own cost analysis counts a loop body
once.  The port has no HLO: its steps are eager, every Python loop trip
dispatches its ops again, so counting what dispatches IS trip-count-aware.
`account(fn, *args)` runs ``fn`` under a ``TorchDispatchMode`` (on meta
tensors for a dry run, or on real ones) and sums:

  flops            — ``2 |out| K`` for each ``mm``, ``addmm``, ``bmm``,
                     ``baddbmm`` (K the contracted extent) and convolution
                     (K = input channels per group x kernel window), plus
                     the GEMM of each kernel #1 / #2 launch
                     (`kernels.abft_matmul.launch_hooks`): the reference's
                     dot and convolution FLOPs
  bytes            — every tensor operand plus every output of each op
                     that computes (views and metadata ops move nothing),
                     a view counted at its own size, not its base's: the
                     each-op-streams-memory proxy, as the reference's
  collective_bytes — per kind, the per-device output bytes of each
                     collective the port's stacked-axis reductions stand
                     for (`dist.collectives.note_collective`: the mean,
                     `abft_psum_tree` and `ef_psum_tree` with its wire's
                     kinds)

A loop trip that stands for identical trips (the train step's DP-shard
and microbatch loops on meta tensors, `train.step.repeat_hooks`) counts
as many times as it stands for, the reference's rule for a loop with a
known trip count; the peak memory is one trip's, as the trips run one
after another.  And, beside these sums, the peak of the storage bytes allocated during the call
and alive at once (``peak_bytes``) and those still alive at its end
(``live_end_bytes``), which the dry run turns into a temporary-memory
estimate.  FLOPs are exact for the dispatched products; bytes are a proxy
(no cache or reuse modelled), consistent across variants.

Counterpart of the reference package's ``repro/launch/hlo_accounting.py``.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["account", "AccountResult", "Accountant"]

_aten = torch.ops.aten
_MM = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
_CONV = {_aten.convolution, _aten.convolution_backward}
# ops that allocate but read and write no element
_EMPTY = {_aten.empty, _aten.empty_strided, _aten.empty_like,
          _aten.new_empty, _aten.new_empty_strided}


class AccountResult(dict):
    """``{"flops", "bytes", "collective_bytes", "peak_bytes",
    "live_end_bytes"}``; ``output`` holds what the accounted call
    returned."""
    output = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors among ``x``, a flat sequence or one level of lists
    (``cat``'s operands), or anything ``tree_flatten`` takes."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        out = []
        for a in x:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (tuple, list)):
                out += [t for t in a if isinstance(t, torch.Tensor)]
        return out
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _mm_flops(func, args, out) -> int:
    pkt = func.overloadpacket
    if pkt in (_aten.mm, _aten.bmm):
        a = args[0]
    else:                                   # addmm / baddbmm: (bias, a, b)
        a = args[1]
    return 2 * out.numel() * a.shape[-1]


def _conv_flops(func, args, out) -> int:
    if func.overloadpacket is _aten.convolution:
        w, groups, y = args[1], args[8], out
        cin = args[0].shape[1] // groups
        return 2 * y.numel() * cin * math.prod(w.shape[2:])
    # convolution_backward(grad_out, input, weight, ...): the input and
    # weight gradients, each a product of the forward's size
    grad_out, w = args[0], args[2]
    groups = args[9]
    cin = args[1].shape[1] // groups
    fwd = 2 * grad_out.numel() * cin * math.prod(w.shape[2:])
    mask = args[10]
    return fwd * (int(mask[0]) + int(mask[1]))


class Accountant(TorchDispatchMode):
    """The dispatch mode `account` runs a call under; usable directly as a
    context manager (its counters are attributes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}   # storage id -> [bytes, refs]
        self._trips: list = []

    # -- live-storage tracking ------------------------------------------

    def _release(self, key: int) -> None:
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._storages[key]

    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        """Count a fresh output's storage as live until its last tensor
        goes; a view of a tracked storage keeps it alive too."""
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return
        ent = self._storages.get(key)
        if ent is None:
            if not fresh:
                return                      # a view of an argument
            ent = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    # -- hooks of the kernels and the reductions -------------------------

    def _on_launch(self, op, read, written) -> None:
        a, b = read[0], read[1]
        self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[-1]
        self.bytes += sum(_nbytes(t) for t in (*read, *written))

    def _on_repeat(self, trips) -> None:
        """A loop trip that stands for ``trips`` identical ones (a meta
        run of `train.step`'s DP-shard and microbatch loops): its FLOPs,
        bytes and collectives count ``trips`` times."""
        if trips is not None:
            self._trips.append((trips, self.flops, self.bytes,
                                dict(self.collective_bytes)))
            return
        trips, flops, nbytes, coll = self._trips.pop()
        self.flops += (trips - 1) * (self.flops - flops)
        self.bytes += (trips - 1) * (self.bytes - nbytes)
        for kind, v in list(self.collective_bytes.items()):
            self.collective_bytes[kind] = v + (trips - 1) * (
                v - coll.get(kind, 0.0))

    def _on_collective(self, kind: str, nbytes: int) -> None:
        self.collective_bytes[kind] = \
            self.collective_bytes.get(kind, 0.0) + nbytes

    def _hooks(self):
        from repro_torch.dist import collectives
        from repro_torch.kernels import abft_matmul as kmm
        from repro_torch.train import step
        return ((kmm.launch_hooks, self._on_launch),
                (collectives.collective_hooks, self._on_collective),
                (step.repeat_hooks, self._on_repeat))

    def __enter__(self):
        for hooks, fn in self._hooks():
            hooks.append(fn)
        return super().__enter__()

    def __exit__(self, *exc):
        for hooks, fn in self._hooks():
            hooks.remove(fn)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        pkt = func.overloadpacket
        inplace = func._schema.name.endswith("_") or any(
            a.is_out for a in func._schema.arguments)
        for t in outs:
            self._track(t, fresh=not (func.is_view or inplace))
        if func.is_view or pkt in _EMPTY:
            return out
        if pkt in _MM:
            self.flops += _mm_flops(func, args, outs[0])
        elif pkt in _CONV:
            self.flops += _conv_flops(func, args, outs[0])
        self.bytes += sum(_nbytes(t) for t in _tensors(args))
        if kwargs:
            self.bytes += sum(_nbytes(t) for t in _tensors(
                list(kwargs.values())))
        self.bytes += sum(_nbytes(t) for t in outs)
        return out


def account(fn, *args, **kwargs) -> AccountResult:
    """Run ``fn(*args, **kwargs)`` under the `Accountant` and return its
    totals; ``result.output`` is what ``fn`` returned (kept alive, so
    ``live_end_bytes`` counts it)."""
    acct = Accountant()
    with acct:
        output = fn(*args, **kwargs)
    res = AccountResult(flops=acct.flops, bytes=acct.bytes,
                        collective_bytes=dict(acct.collective_bytes),
                        peak_bytes=acct.peak, live_end_bytes=acct.live)
    res.output = output
    return res

"""Dispatchers over the port's kernels.

``pick_blocks`` plans the tiling for any (m, k, n): the CTA tile
``(bm, bn)`` comes from the tiles the CUDA kernel is built for, and a time
model over the H100's published memory and CUDA-core rates ranks the
candidates.  ``abft_matmul`` runs the fused dual-checksum kernel (or, for a
CPU tensor, its plain version) and reduces the per-tile partials.

Counterpart of the reference package's ``repro/kernels/ops.py``.  The
accumulate family (``abft_matmul_acc``, ``tile_checksums``,
``correct_from_state``), ``checksum_encode`` and the measured autotuner
come with later slices.  There is no custom VJP yet: the port serves, and
training through the kernel comes with the protected-LM slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.chaos.faults import register_surface
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import ref

__all__ = [
    "BlockPlan", "abft_matmul", "detection_eps", "kernel_weights",
    "pick_blocks", "rank_blocks", "smem_bytes",
]

KERNEL_F = 2  # checksums per direction: plain sum + one weighted row

# The carried per-tile state of the accumulate kernel family is this
# module's protection domain in the reference.  The port has not brought
# that kernel up yet, so the surface sits on the uncovered ledger.
register_surface(
    "kernels.ops/acc_state", owner=__name__, protected=False,
    kinds=("sdc_collective", "checksum_state_flip"),
    note="carried (ccol, crow) state of abft_matmul_acc: its verify/correct "
         "kernel comes with the SUMMA slice")


def kernel_weights(m: int, f: int = KERNEL_F, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """[f, m] checkpoint matrix used by the fused kernels (row 0 = sum)."""
    return ref.default_weights(m, f, dtype=dtype, device=device)


def detection_eps(dtype) -> float:
    """Dtype-aware detection epsilon for the ABFT residual tolerances.

    The checksums are fp32 functions of the ROUNDED stored values, so fp32
    eps is the floor for any storage dtype (including integers, whose
    checksums are exact below 2^24); wider-rounding float storage (bf16)
    contributes its own eps.
    """
    eps32 = torch.finfo(torch.float32).eps
    if not dtype.is_floating_point:
        return float(eps32)
    return float(max(torch.finfo(dtype).eps, eps32))


# ---------------------------------------------------------------------------
# Tiling plan
# ---------------------------------------------------------------------------

# Planner time model over published H100 SXM figures (NVIDIA data sheet):
# device memory and the CUDA-core fp32 rate, which is what the kernel runs
# on for every operand type.  A grid with fewer CTAs than SMs leaves SMs
# idle, so the compute term scales with the share of SMs that get a CTA.
# A model for ranking tiles, not a measurement.
HBM_BW = 3.35e12                     # bytes/s
CUDA_CORE_FLOPS = 67e12              # fp32 FMA rate, FLOP/s
N_SM = 132
SMEM_STATIC = 48 * 1024              # static shared memory per block


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A tiling for an (m, k, n) matmul.

    ``bm``/``bn`` are the CTA tile, ``bk`` the k block; ``pm/pk/pn`` are the
    dims rounded up to them (the kernel masks the ragged edge, so the
    padding costs idle lanes, not bytes); ``cost_bytes`` is the modeled
    device-memory traffic including the checksum-partial writes.
    """
    m: int
    k: int
    n: int
    bm: int
    bn: int
    bk: int
    pm: int
    pk: int
    pn: int
    cost_bytes: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.pm // self.bm, self.pn // self.bn, self.pk // self.bk)

    @property
    def exact(self) -> bool:
        return (self.pm, self.pk, self.pn) == (self.m, self.k, self.n)

    @property
    def waste(self) -> float:
        """Relative extra FLOPs spent on padding (0.0 for aligned shapes)."""
        return self.pm * self.pk * self.pn / (self.m * self.k * self.n) - 1.0


def _round_up(x: int, b: int) -> int:
    return -(-x // b) * b


def smem_bytes(bm: int, bn: int, bk: int = kmm.KT) -> int:
    """Static shared memory of one CTA: the staged A/B slabs (widened to
    4-byte fp32 or int32 for every operand type) or the epilogue's
    partial-sum buffer, which reuses the same bytes."""
    loop = bk * (bm + 1 + bn) * 4
    epi = 16 * kmm.F_MAX * max(bm, bn) * 4
    return max(loop, epi)


def _plan_time(plan: BlockPlan, in_bytes: int, out_bytes: int, f: int):
    """(modeled seconds, modeled bytes) of one launch under ``plan``."""
    mt, nt, _ = plan.grid
    m, k, n = plan.m, plan.k, plan.n
    total_bytes = (m * k * nt * in_bytes          # A once per column of tiles
                   + k * n * mt * in_bytes        # B once per row of tiles
                   + m * n * out_bytes            # C
                   + mt * f * n * 4 + nt * m * f * 4)   # checksum partials
    fill = min(1.0, mt * nt / N_SM)
    flops = 2 * plan.pm * plan.pk * plan.pn + 4 * f * plan.pm * plan.pn
    t = max(total_bytes / HBM_BW, flops / (CUDA_CORE_FLOPS * fill))
    return t, total_bytes


def rank_blocks(m: int, k: int, n: int, *, in_dtype=torch.float32,
                out_bytes: int = 4, f: int = KERNEL_F) -> list:
    """All tilings for an (m, k, n) ABFT-GEMM, best-first.

    Candidates are the CTA tiles the kernel is built for (k staged in
    ``KT`` slabs); each is scored by the modeled time
    ``max(bytes / HBM_BW, FLOPs / (rate * SM fill))``, ties broken toward
    fewer bytes, then bigger tiles.
    """
    in_bytes = in_dtype.itemsize
    ranked = []
    for bm in kmm.TILES_M:
        for bn in kmm.TILES_N:
            if smem_bytes(bm, bn) > SMEM_STATIC:
                continue
            cand = BlockPlan(m=m, k=k, n=n, bm=bm, bn=bn, bk=kmm.KT,
                             pm=_round_up(m, bm), pk=_round_up(k, kmm.KT),
                             pn=_round_up(n, bn), cost_bytes=0)
            t, cost = _plan_time(cand, in_bytes, out_bytes, f)
            ranked.append(((t, cost, -(bm * bn)),
                           dataclasses.replace(cand, cost_bytes=cost)))
    ranked.sort(key=lambda kp: kp[0])
    return [p for _, p in ranked]


@functools.lru_cache(maxsize=4096)
def pick_blocks(m: int, k: int, n: int, **kw) -> BlockPlan:
    """Best tiling under the time model — ``rank_blocks(...)[0]``.
    Memoized: every protected projection asks
    for its plan on every call, and ranking costs more host time than a
    decode-size launch."""
    return rank_blocks(m, k, n, **kw)[0]


# ---------------------------------------------------------------------------
# One-shot fused matmul
# ---------------------------------------------------------------------------


def _run_oneshot(plan: BlockPlan, out_dtype, a, b, wm, wn):
    """Kernel call + cross-tile reduction of the partials.

    The kernel masks ragged edges itself, so nothing is padded in memory
    and no weight is copied per call; its partials cover exactly [:m] rows
    and [:n] columns.  The reference zero-pads to ``plan.pm``/``plan.pn``
    and slices after the sum: the same numbers, since zero padding commutes
    with the encoding.
    """
    c, ccol, crow = kmm.abft_matmul_cuda(
        a.contiguous(), b.contiguous(), wm.float().contiguous(),
        wn.float().contiguous(), bm=plan.bm, bn=plan.bn, bk=plan.bk,
        out_dtype=out_dtype)
    cs_col = ccol.sum(dim=0)[:, : plan.n]
    cs_row = crow.sum(dim=0)[: plan.m, :]
    return c[: plan.m, : plan.n], cs_col, cs_row


@functools.lru_cache(maxsize=4096)
def _publish_dispatch(m: int, k: int, n: int, dtype: str, backend: str):
    """Count and record the first dispatch of each (shape, dtype, backend):
    the eager counterpart of the reference's trace, which happens once per
    compiled program, not once per call."""
    obs.counter("repro_kernel_traces_total",
                "kernel dispatches of a new shape").inc(op="abft_matmul",
                                                        backend=backend)
    obs.event("kernel/trace", op="abft_matmul", backend=backend,
              m=m, k=k, n=n, dtype=dtype)


def abft_matmul(a: torch.Tensor, b: torch.Tensor, *, f: int = KERNEL_F,
                wm: Optional[torch.Tensor] = None,
                wn: Optional[torch.Tensor] = None, out_dtype=None,
                plan: Optional[BlockPlan] = None):
    """C = A @ B with fused dual checksums -> (c, cs_col [f,n], cs_row [m,f]).

    Custom weight matrices turn the row direction into arbitrary fused
    epilogue reductions of C (e.g. ``core.abft_gemm`` passes
    ``wn = [w_r; -I]`` so cs_row IS the verification residual, with zero
    extra reads of C).  A CUDA tensor launches the kernel or raises; a CPU
    tensor runs the kernel's plain version.  The kernel masks ragged
    edges, so every shape takes it (``ref.abft_matmul_ref`` is the test
    oracle, not a fallback).
    """
    m, k = a.shape
    n = b.shape[1]
    if out_dtype is None:
        # int8 inputs accumulate exactly in int32 — an int8 output would
        # overflow on the first dot
        out_dtype = torch.int32 if a.dtype == torch.int8 else a.dtype
    if wm is not None:
        f = wm.shape[0]   # before building the default wn: shapes must agree
    wm = kernel_weights(m, f, device=a.device) if wm is None else wm
    wn = kernel_weights(n, f, device=a.device).T if wn is None else wn
    if tuple(wn.shape) != (n, f):
        raise ValueError(f"wn shape {tuple(wn.shape)} != ({n}, {f})")
    if plan is None:
        plan = pick_blocks(m, k, n, in_dtype=a.dtype,
                           out_bytes=out_dtype.itemsize, f=f)
    _publish_dispatch(m, k, n, str(a.dtype).replace("torch.", ""),
                      "cuda" if a.is_cuda else "plain")
    return _run_oneshot(plan, out_dtype, a, b, wm, wn)

"""Dispatchers over the port's kernels.

``pick_blocks`` plans the tiling for any (m, k, n) under a time model
over the H100's published memory, tensor-core and CUDA-core rates.  A
one-shot plan is one of kernel #1's routes: its tensor-core tiles, or for
m <= 32 its split-k stream; an accumulate plan (``carry=True``) is one of
kernel #2's routes: the same tensor-core tiles, or its CUDA-core tiles.
``abft_matmul`` runs the fused dual-checksum kernel (or, for a CPU
tensor, its plain version) and reduces the per-tile partials.
``abft_matmul_acc`` runs the accumulate step with its carried per-tile
checksum state and fused verify/correct prologue: the kernel on a CUDA
tensor, or the separate-op PyTorch twin (``backend="torch"``).
``tile_checksums``, ``reduce_state``, ``correct_from_state`` and
``_tile_verify_correct`` are the state's plain-PyTorch algebra.

The carried state has kernel #1's partial layout, ``ccol [ceil(m/bm), f,
n]`` and ``crow [ceil(n/bn), m, f]``: the reference's zero-padded layout
``[pm/bm, f, pn]`` / ``[pn/bn, pm, f]`` with the padding (always zero)
sliced off, so the two agree wherever the tiling divides the shape.

``abft_matmul`` is differentiable: ``_FusedMM`` is the reference's custom
VJP as a ``torch.autograd.Function`` (the kernel forward, the checksum
cotangents folded into dC in the backward).  ``abft_matmul_grouped`` runs
kernel #1g, the experts' products of a mixture-of-experts layer over rows
sorted by expert (`ExpertGroups`), differentiable through ``_GroupedMM``.
``checksum_encode`` is the diskless-checkpoint encode: kernel #3 on a CUDA
tensor, its plain version on a CPU one, at any [p, m, n].

``plan_accounting`` is a plan's structural byte and FLOP terms (the
reference's formulas, integer for integer) beside this time model's
terms; ``kernels.autotune`` measures the top of ``rank_blocks`` on the
card and ``abft_matmul`` resolves its plan through ``autotune.best_plan``.

Counterpart of the reference package's ``repro/kernels/ops.py``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.chaos.faults import register_surface
from repro_torch.kernels import abft_matmul as kmm
from repro_torch.kernels import checksum_encode as kenc
from repro_torch.kernels import ref

__all__ = [
    "BlockPlan", "ExpertGroups", "abft_matmul", "abft_matmul_acc",
    "abft_matmul_grouped", "acc_state_zeros",
    "checksum_encode", "correct_from_state", "detection_eps",
    "kernel_weights", "oneshot_smem_bytes", "pick_blocks",
    "plan_accounting", "rank_blocks", "reduce_state", "smem_bytes",
    "tensor_rate", "tile_checksums",
]

KERNEL_F = 2  # checksums per direction: plain sum + one weighted row

# the protection domain this module owns: the carried (ccol, crow)
# per-tile state of the accumulate kernel family
register_surface(
    "kernels.ops/acc_state", owner=__name__, protected=True,
    promise="tolerance",
    detector="fused verify/correct prologue of abft_matmul_acc: per-tile "
             "residual of recomputed vs carried dual checksums; "
             "concentration-gated single-element repair by masked "
             "re-computation from the carried plain-sum column checksum",
    kinds=("sdc_collective", "checksum_state_flip"),
    note="a flip in the carried DATA is located and repaired (bit-exact on "
         "integer data); a flip in the carried CHECKSUM state trips only "
         "one residual family, so it is detected but deliberately NOT "
         "repaired (repairing would corrupt healthy data) — refresh via "
         "tile_checksums instead")


# the grouped products of a mixture-of-experts layer (kernel #1g): each
# row's residual reduced in the epilogue, checked row by row
register_surface(
    "kernels.ops/abft_matmul_grouped", owner=__name__, protected=True,
    promise="tolerance",
    detector="kernel #1g's epilogue reduces each row's §4.3 residual "
             "[Y, Ycs] @ [w_r; -I] from the stored tile; "
             "core.abft_gemm.correct_rows trips a row over tol * n * eps * "
             "mean|Y| and repairs its one corrupted element (column by the "
             "weighted residual's ratio, one refinement pass)",
    note="one corrupted element a row is located and repaired, so a flip "
         "in every row of the experts' output is; drilled by "
         "tests/test_torch_moonlight.py (no campaign fault kind targets "
         "the experts yet); trips are counted in repro_detections_total "
         "at the layer's one host read, in the backward")


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
# device memory, the CUDA-core fp32 rate (kernel #2's small tiles and
# kernel #1's split-k stream) and the dense tensor-core rates of both
# kernels' tensor-core tiles, where fp32 operands take three TF32 passes
# (3xTF32).  A grid with fewer CTAs than SMs leaves SMs idle, so the
# compute term scales with the share of SMs that get a CTA.  A model for
# ranking tiles, not a measurement.
HBM_BW = 3.35e12                     # bytes/s
CUDA_CORE_FLOPS = 67e12              # fp32 FMA rate, FLOP/s
TENSOR_FLOPS = {                     # the tensor-core tiles, FLOP/s
    torch.float32: 495e12 / 3,       # 3xTF32: three TF32 products
    torch.bfloat16: 989e12,
    torch.int8: 1979e12,
}
N_SM = 132                           # H100 SXM streaming multiprocessors
SMEM_STATIC = 48 * 1024              # static shared memory per block
SMEM_DYNAMIC = 232448                # most dynamic shared memory per block


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A tiling for an (m, k, n) matmul.

    ``bm``/``bn`` are the CTA tile, ``bk`` the k block; ``pm/pk/pn`` are the
    dims rounded up to them (the kernel masks the ragged edge, so the
    padding costs idle lanes, not bytes); ``cost_bytes`` is the modeled
    device-memory traffic including the checksum-partial writes.
    ``route`` is "mma" or "splitk" for kernel #1 and "mma" or
    "cuda_core" for kernel #2 (``kmm.route_of``); ``splits`` is a split-k
    plan's k slices.
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
    route: str = "cuda_core"
    splits: int = 1

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


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def smem_bytes(bm: int, bn: int, bk: int = kmm.KT,
               in_dtype=torch.float32) -> int:
    """Shared memory of one kernel-#2 CTA.  Tensor-core tiles (dynamic):
    for fp32 operands the TMA ring of the 3xTF32 planes, for bf16 and int8
    the ring of kernel #1's (``oneshot_smem_bytes``); either also holds the
    prologue's reductions and the staged C tile.  CUDA-core tiles (static):
    the staged A/B slabs (widened to 4-byte fp32 or int32 for every operand
    type) or the epilogue's partial-sum buffer, which reuses the same
    bytes."""
    if kmm.reads_planes(bm, bn, in_dtype):
        # abft_wgmma.cuh: 3 stages of 128-byte rows of the four 3xTF32
        # planes, or the staged C tile, and 1 KB to align them
        return max(3 * 2 * (bm + bn) * 128, bm * (bn + 4) * 4) + 1024
    if kmm.route_of(bm, bn, carry=True) == "mma":
        return oneshot_smem_bytes(bm, bn, in_dtype)
    loop = bk * (bm + 1 + bn) * 4
    epi = 16 * kmm.F_MAX * max(bm, bn) * 4
    return max(loop, epi)


def oneshot_smem_bytes(bm: int, bn: int, in_dtype=torch.float32) -> int:
    """Shared memory of one kernel-#1 CTA.  Tensor-core tiles (dynamic,
    ``abft_mma.cuh``'s ``TileCfg``): a 3-stage cp.async ring of ``bm``
    rows x ``MMA_SLAB`` bytes of A and ``MMA_SLAB`` bytes' worth of k rows
    of B (rows padded by 16 bytes, 32 for fp32 B), whose bytes then hold
    the staged fp32 tile and the epilogue's buffer.  Split-k (static):
    pass 1's slice of A or its reduction buffer (32 KB at most), pass 2's
    epilogue buffer."""
    epi = 16 * kmm.F_MAX * max(bm, bn) * 4
    if kmm.route_of(bm, bn) == "mma":
        s = in_dtype.itemsize
        slab = kmm.MMA_SLAB
        ring = 3 * (bm * (slab + 16) + (slab // s) * (bn * s + (32 if s == 4
                                                                else 16)))
        return max(ring, bm * (bn + 4) * 4, epi)
    return max(32 * 1024, epi)


def _plan_time(plan: BlockPlan, in_bytes: int, out_bytes: int, f: int,
               carry: bool = False):
    """(modeled seconds, modeled bytes) of one kernel-#2 launch under
    ``plan`` (CUDA cores); ``carry`` adds the accumulate kernel's reads of
    C_in and of the carried state and its stats writes."""
    mt, nt, _ = plan.grid
    m, k, n = plan.m, plan.k, plan.n
    cs_bytes = mt * f * n * 4 + nt * m * f * 4          # checksum partials
    total_bytes = (m * k * nt * in_bytes          # A once per column of tiles
                   + k * n * mt * in_bytes        # B once per row of tiles
                   + m * n * out_bytes            # C
                   + cs_bytes)
    if carry:
        total_bytes += m * n * out_bytes + cs_bytes + mt * nt * 8 * 4
    fill = min(1.0, mt * nt / N_SM)
    flops = 2 * plan.pm * plan.pk * plan.pn + 4 * f * plan.pm * plan.pn
    t = max(total_bytes / HBM_BW, flops / (CUDA_CORE_FLOPS * fill))
    return t, total_bytes


def _oneshot_time(plan: BlockPlan, in_dtype, out_bytes: int, f: int,
                  carry: bool = False):
    """(modeled seconds, modeled bytes) of one kernel-#1 call.  Tensor-core
    tiles: A once per column of tiles, B once per row of tiles, the
    products at the tensor-core rate of the operand type.  Split-k: B once,
    A once per 128 columns, the fp32 workspace written and read once, the
    products on CUDA cores over ``ceil(n/128) x splits`` CTAs.  A grid
    with fewer CTAs than SMs leaves both the idle SMs' compute and their
    share of the memory bandwidth unused.  ``carry`` scores kernel #2's
    tensor-core route: the same, plus the accumulate's reads of C_in and
    of the carried state and its stats writes (as ``_plan_time``)."""
    mt, nt, _ = plan.grid
    m, k, n = plan.m, plan.k, plan.n
    in_bytes = in_dtype.itemsize
    cs_bytes = mt * f * n * 4 + nt * m * f * 4
    fixed = m * n * out_bytes + cs_bytes
    if carry:
        fixed += m * n * out_bytes + cs_bytes + mt * nt * 8 * 4
    epi_flops = 4 * f * plan.pm * plan.pn
    if plan.route == "mma":
        total = m * k * nt * in_bytes + k * n * mt * in_bytes + fixed
        ctas, rate = mt * nt, TENSOR_FLOPS[in_dtype]
        flops = 2 * plan.pm * plan.pk * plan.pn + epi_flops
    else:
        cols = _cdiv(n, kmm.SPLIT_COLS)
        total = (m * k * cols * in_bytes + k * n * in_bytes
                 + 2 * plan.splits * m * n * 4 + fixed)
        ctas, rate = cols * plan.splits, CUDA_CORE_FLOPS
        flops = 2 * plan.pm * k * cols * kmm.SPLIT_COLS + epi_flops
    fill = min(1.0, ctas / _sms())
    return max(total / HBM_BW, flops / rate) / fill, total


def tensor_rate(in_dtype) -> float:
    """Modeled FLOP/s of the tensor-core tiles for an A/B operand type
    (the H100 counterpart of the reference's ``mxu_rate``)."""
    return TENSOR_FLOPS[in_dtype]


def plan_accounting(plan: BlockPlan, *, in_dtype=torch.float32,
                    out_bytes: int = 4, f: int = KERNEL_F,
                    carry: bool = False) -> dict:
    """Structural byte and FLOP terms of ``plan`` beside the H100 time
    model's.

    The structural terms are the reference's formulas on the padded dims
    (``repro/kernels/ops.py::plan_accounting``), integer for integer: A
    streamed once per column of tiles, B once per row of tiles, C written
    once (read and written once more with a carried state), the per-tile
    checksum partials written (``cs_wr_bytes``) and no extra read of C for
    either fused direction (``extra_hbm_rd_*`` 0), where an unfused encode
    would read C once per direction (``unfused_extra_rd``).  The time
    terms are this module's model of the route the plan runs
    (``_oneshot_time`` for kernel #1 and kernel #2's tensor-core tiles,
    ``_plan_time`` for kernel #2's CUDA-core tiles), which masks ragged
    edges instead of padding them: ``model_bytes`` are its bytes and
    ``t_total_s`` its seconds, the ranking ``rank_blocks`` sorts on."""
    mt, nt, _ = plan.grid
    in_bytes = in_dtype.itemsize
    gemm_rd = (plan.pm * plan.pk * nt * in_bytes
               + plan.pk * plan.pn * mt * in_bytes)
    gemm_wr = plan.pm * plan.pn * out_bytes
    cs_wr = mt * f * plan.pn * 4 + nt * plan.pm * f * 4
    carry_bytes = 0
    if carry:  # C_in read + carried-state read + stats write
        carry_bytes = (plan.pm * plan.pn * out_bytes + cs_wr
                       + mt * nt * kmm.STATS_WIDTH * 4)
    if carry and plan.route == "cuda_core":
        t, model_bytes = _plan_time(plan, in_bytes, out_bytes, f, carry)
        rate = CUDA_CORE_FLOPS
    else:
        t, model_bytes = _oneshot_time(plan, in_dtype, out_bytes, f, carry)
        rate = tensor_rate(in_dtype) if plan.route == "mma" \
            else CUDA_CORE_FLOPS
    return dict(
        gemm_bytes=gemm_rd + gemm_wr,
        extra_hbm_rd_col=0,
        extra_hbm_rd_row=0,
        cs_wr_bytes=cs_wr,
        carry_bytes=carry_bytes,
        unfused_extra_rd=2 * plan.pm * plan.pn * out_bytes,
        flops=2 * plan.pm * plan.pk * plan.pn,
        cs_flops=4 * f * plan.pm * plan.pn,
        total_bytes=gemm_rd + gemm_wr + cs_wr + carry_bytes,
        route=plan.route,
        rate=rate,
        model_bytes=model_bytes,
        t_hbm_s=model_bytes / HBM_BW,
        t_total_s=t,
    )


def _sms() -> int:
    """SMs of the current card, or the model's ``N_SM`` without one: what
    kernel #1's split count and its plans' SM fill are taken for."""
    if torch.cuda.is_available():
        return kmm.sm_count(torch.cuda.current_device())
    return N_SM


def _oneshot_candidates(m: int, k: int, n: int, in_dtype):
    """Kernel #1's plans: each tensor-core tile, and for m <= 32 the
    split-k stream on the smallest row tile that holds m, at each width."""
    bk = kmm.MMA_SLAB // in_dtype.itemsize     # k per stage of the ring
    for bm, bn in kmm.MMA_TILES:
        yield BlockPlan(m=m, k=k, n=n, bm=bm, bn=bn, bk=bk,
                        pm=_round_up(m, bm), pk=_round_up(k, bk),
                        pn=_round_up(n, bn), cost_bytes=0, route="mma")
    if m <= max(kmm.SPLITK_TILES_M):
        bm = min(t for t in kmm.SPLITK_TILES_M if t >= m)
        splits = kmm.split_count(m, k, n, _sms())
        for bn in kmm.TILES_N:
            yield BlockPlan(m=m, k=k, n=n, bm=bm, bn=bn, bk=kmm.KT,
                            pm=_round_up(m, bm), pk=_round_up(k, kmm.KT),
                            pn=_round_up(n, bn), cost_bytes=0,
                            route="splitk", splits=splits)


def rank_blocks(m: int, k: int, n: int, *, in_dtype=torch.float32,
                out_bytes: int = 4, f: int = KERNEL_F, carry: bool = False,
                require_exact: bool = False) -> list:
    """All tilings for an (m, k, n) ABFT-GEMM, best-first.

    One-shot (``carry=False``): kernel #1's routes, each scored by
    ``_oneshot_time``.  Accumulate (``carry=True``): kernel #2's tiles,
    each on its route (``kmm.route_of(carry=True)``): the tensor-core
    tiles (k in ring stages of ``kmm.MMA_SLAB`` bytes) scored by
    ``_oneshot_time``'s tensor-core rate with the accumulate's extra
    traffic, the CUDA-core tiles (k staged in ``KT`` slabs) by
    ``_plan_time``, the modeled ``max(bytes / HBM_BW, FLOPs / (rate * SM
    fill))`` with the same traffic.  Ties go toward fewer bytes, then
    bigger tiles.  ``require_exact`` keeps only tilings that divide (m, k,
    n) with no ragged edge, as the reference's SUMMA local update asks for
    its long-lived carried state (the kernels mask ragged edges, so a
    ragged plan is a choice, not a fault).
    """
    ranked = []
    if not carry:
        for cand in _oneshot_candidates(m, k, n, in_dtype):
            if require_exact and not cand.exact:
                continue
            t, cost = _oneshot_time(cand, in_dtype, out_bytes, f)
            ranked.append(((t, cost, -(cand.bm * cand.bn)),
                           dataclasses.replace(cand, cost_bytes=cost)))
        ranked.sort(key=lambda kp: kp[0])
        return [p for _, p in ranked]
    in_bytes = in_dtype.itemsize
    for bm in kmm.TILES_M:
        for bn in kmm.TILES_N:
            route = kmm.route_of(bm, bn, carry=True)
            mma = route == "mma"
            limit = SMEM_DYNAMIC if mma else SMEM_STATIC
            if smem_bytes(bm, bn, in_dtype=in_dtype) > limit:
                continue
            bk = kmm.MMA_SLAB // in_bytes if mma else kmm.KT   # k a stage
            cand = BlockPlan(m=m, k=k, n=n, bm=bm, bn=bn, bk=bk,
                             pm=_round_up(m, bm), pk=_round_up(k, bk),
                             pn=_round_up(n, bn), cost_bytes=0, route=route)
            if require_exact and not cand.exact:
                continue
            if mma:
                t, cost = _oneshot_time(cand, in_dtype, out_bytes, f,
                                        carry=True)
            else:
                t, cost = _plan_time(cand, in_bytes, out_bytes, f, carry)
            ranked.append(((t, cost, -(bm * bn)),
                           dataclasses.replace(cand, cost_bytes=cost)))
    ranked.sort(key=lambda kp: kp[0])
    return [p for _, p in ranked]


@functools.lru_cache(maxsize=4096)
def pick_blocks(m: int, k: int, n: int, **kw) -> Optional[BlockPlan]:
    """Best tiling under the time model — ``rank_blocks(...)[0]``, or None
    when no candidate qualifies (only possible with ``require_exact``).
    Memoized: every protected projection asks
    for its plan on every call, and ranking costs more host time than a
    decode-size launch."""
    ranked = rank_blocks(m, k, n, **kw)
    return ranked[0] if ranked else None


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
        out_dtype=out_dtype, splits=plan.splits)
    cs_col = ccol.sum(dim=0)[:, : plan.n]
    cs_row = crow.sum(dim=0)[: plan.m, :]
    return c[: plan.m, : plan.n], cs_col, cs_row


class _FusedMM(torch.autograd.Function):
    """The one-shot path with the reference's custom VJP
    (``repro/kernels/ops.py::_fused_mm_bwd``): the forward is the kernel
    (its plain version on a CPU tensor); the backward folds the checksum
    cotangents into dC (``cs_col = W_m @ C`` gives ``dC += W_m^T g_col``,
    ``cs_row = C @ W_n`` gives ``dC += g_row W_n^T``) and takes the two
    operand gradients as plain fp32 products, as the reference leaves them
    to XLA.  The encoding weights are constants of the scheme: they get
    zero gradients."""

    @staticmethod
    def forward(ctx, plan, out_dtype, a, b, wm, wn):
        ctx.save_for_backward(a, b, wm, wn)
        return _run_oneshot(plan, out_dtype, a, b, wm, wn)

    @staticmethod
    def backward(ctx, gc, gcol, grow):
        a, b, wm, wn = ctx.saved_tensors
        gc32 = (gc.float() + torch.matmul(wm.float().T, gcol.float())
                + torch.matmul(grow.float(), wn.float().T))
        need = ctx.needs_input_grad
        ga = torch.matmul(gc32, b.float().T).to(a.dtype) if need[2] else None
        gb = torch.matmul(a.float().T, gc32).to(b.dtype) if need[3] else None
        gwm = torch.zeros_like(wm) if need[4] else None
        gwn = torch.zeros_like(wn) if need[5] else None
        return None, None, ga, gb, gwm, gwn


@functools.lru_cache(maxsize=4096)
def _publish_dispatch(op: str, m: int, k: int, n: int, dtype: str,
                      backend: str):
    """Count and record the first dispatch of each (op, shape, dtype,
    backend): the eager counterpart of the reference's trace, which happens
    once per compiled program, not once per call."""
    obs.counter("repro_kernel_traces_total",
                "kernel dispatches of a new shape").inc(op=op,
                                                        backend=backend)
    obs.event("kernel/trace", op=op, backend=backend,
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
    tensor runs the kernel's plain version.  Differentiable in ``a`` and
    ``b`` through ``_FusedMM``.  The kernel masks ragged edges, so every
    shape takes it (``ref.abft_matmul_ref`` is the test oracle, not a
    fallback).
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
        # layered plan resolution: a measured winner when the autotune cache
        # or its env override holds one, the time model otherwise (dispatch
        # never measures)
        from repro_torch.kernels import autotune  # lazy: autotune imports ops
        plan = autotune.best_plan(m, k, n, in_dtype=a.dtype,
                                  out_dtype=out_dtype, f=f, device=a.device)
    _publish_dispatch("abft_matmul", m, k, n,
                      str(a.dtype).replace("torch.", ""),
                      "cuda" if a.is_cuda else "plain")
    return _FusedMM.apply(plan, out_dtype, a, b, wm, wn)


# ---------------------------------------------------------------------------
# Grouped one-shot products (the experts of a mixture-of-experts layer)
# ---------------------------------------------------------------------------


class ExpertGroups:
    """Rows sorted by expert: ``offsets`` [E + 1] int64 on the rows'
    device, expert e owning rows ``offsets[e]`` to ``offsets[e + 1]``.

    The forward of a grouped product never reads the offsets on the host;
    the backward's per-expert products need them there, and `host` reads
    them once for every product sharing this object (a layer's gate, up
    and down), together with any device counts `read_with` queued, whose
    callbacks then get their host values.  ``trips`` is the device count
    of rows whose residual tripped in the checks of these products
    (`core.abft_gemm.abft_matmul_grouped` adds to it), or None."""

    def __init__(self, offsets: torch.Tensor):
        self.offsets = offsets
        self.trips = None
        self._host = None
        self._extra = []          # [(0-d device tensor, fn(value))]

    def read_with(self, value: torch.Tensor, fn) -> None:
        """Read ``value`` (a 0-d count on the device) with the offsets, and
        call ``fn`` with it then."""
        self._extra.append((value, fn))

    def host(self) -> list:
        """The offsets as Python ints: one host read, on first call."""
        if self._host is None:
            vals = torch.cat([self.offsets] + [
                v.reshape(1).to(self.offsets.dtype) for v, _ in self._extra])
            vals = vals.tolist()
            e1 = self.offsets.shape[0]
            self._host = vals[:e1]
            for (_, fn), v in zip(self._extra, vals[e1:]):
                fn(v)
            self._extra = []
        return self._host


class _GroupedMM(torch.autograd.Function):
    """Kernel #1g with its VJP.  The forward returns ``(Y, Ycs, res)``,
    ``res = Y @ w_r - Ycs`` each row's residual; ``w_cs`` is taken as the
    function ``W @ w_r`` it encodes, so the cotangents of Ycs and res fold
    into Y's: ``res`` is identically zero as a function of X and W, and
    ``Ycs = (X W) w_r``, so ``dY_total = dY + dYcs w_r^T``.  The operand
    gradients are then plain fp32 products expert by expert, as
    ``_FusedMM`` takes them, over the offsets read once on the host
    (`ExpertGroups.host`)."""

    @staticmethod
    def forward(ctx, groups, bm, bn, x, w, w_cs, wn):
        y, ycs, crow = kmm.abft_matmul_grouped_cuda(
            x, w, w_cs, groups.offsets, wn, bm=bm, bn=bn)
        ctx.groups = groups
        ctx.save_for_backward(x, w, wn)
        return y, ycs, crow.sum(dim=0)

    @staticmethod
    def backward(ctx, gy, gcs, _gres):
        x, w, wn = ctx.saved_tensors
        n = w.shape[-1]
        g = gy.float() + torch.matmul(gcs.float(), wn[:n].T)
        bounds = ctx.groups.host()
        need = ctx.needs_input_grad
        gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
            if need[3] else None
        gw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) \
            if need[4] else None
        for e in range(w.shape[0]):
            a, b = bounds[e], bounds[e + 1]
            if b == a:
                continue
            if gx is not None:
                torch.matmul(g[a:b], w[e].float().T, out=gx[a:b])
            if gw is not None:
                torch.matmul(x[a:b].float().T, g[a:b], out=gw[e])
        return (None, None, None,
                None if gx is None else gx.to(x.dtype),
                None if gw is None else gw.to(w.dtype), None, None)


def abft_matmul_grouped(x: torch.Tensor, w: torch.Tensor,
                        w_cs: torch.Tensor, groups: ExpertGroups,
                        wn: torch.Tensor):
    """Each expert's rows times its weights, with the checksum columns and
    each row's §4.3 residual: -> (y [rows, n], ycs [rows, f], res [rows,
    f]), fp32.

    x: [rows, k] sorted by expert (``groups``); w: [E, k, n]; w_cs [E, k,
    f] = ``W @ w_r`` (its gradient is folded into w's); wn: [n + f, f] =
    ``[w_r; -I]``.  Kernel #1g on a CUDA tensor (no host read), its plain
    version on a CPU tensor; differentiable in x and w."""
    n = w.shape[-1]
    bm, bn = kmm.grouped_tile(n)
    _publish_dispatch("abft_matmul_grouped", x.shape[0], x.shape[1], n,
                      str(x.dtype).replace("torch.", ""),
                      "cuda" if x.is_cuda else "plain")
    return _GroupedMM.apply(groups, bm, bn, x, w, w_cs.detach(), wn)


# ---------------------------------------------------------------------------
# Accumulate variant + carried checksum state
# ---------------------------------------------------------------------------


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad the last two dims of ``x`` to [rows, cols]."""
    r, c = x.shape[-2:]
    if (r, c) == (rows, cols):
        return x
    return F.pad(x, (0, cols - c, 0, rows - r))


def _pad_state(state, pm: int, pn: int):
    """The port's state layout -> the reference's zero-padded one:
    ccol [..., mt, f, n] -> [..., mt, f, pn], crow [..., nt, m, f] ->
    [..., nt, pm, f]."""
    ccol, crow = state
    return (F.pad(ccol, (0, pn - ccol.shape[-1])),
            F.pad(crow, (0, 0, 0, pm - crow.shape[-2])))


def _tiles(c32: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """[..., pm, pn] -> [..., mt, nt, bm, bn]."""
    *lead, pm, pn = c32.shape
    return c32.reshape(*lead, pm // bm, bm, pn // bn, bn).transpose(-3, -2)


def _tile_sums(t, wmt, wnt):
    """Dual checksums of every tile: t [..., mt, nt, bm, bn], wmt
    [mt, f, bm], wnt [nt, bn, f] -> (W_m @ tile [..., mt, nt, f, bn],
    tile @ W_n [..., mt, nt, bm, f]).  The one routine for states and
    residuals, so a clean state re-verifies with residual exactly 0."""
    return (torch.einsum("xfb,...xybn->...xyfn", wmt, t),
            torch.einsum("...xybn,ynf->...xybf", t, wnt))


def _tile_weights(wm, wn, bm: int, bn: int):
    """Padded [f, pm] / [pn, f] weights -> per-tile [mt, f, bm] /
    [nt, bn, f]."""
    f, pm = wm.shape
    pn = wn.shape[0]
    return (wm.float().reshape(f, pm // bm, bm).transpose(0, 1),
            wn.float().reshape(pn // bn, bn, f))


def acc_state_zeros(plan: BlockPlan, f: int = KERNEL_F, device=None):
    """Carried checksum state for C = 0 under ``plan``."""
    mt, nt, _ = plan.grid
    return (torch.zeros((mt, f, plan.n), dtype=torch.float32, device=device),
            torch.zeros((nt, plan.m, f), dtype=torch.float32, device=device))


def tile_checksums(c: torch.Tensor, wm: torch.Tensor, wn: torch.Tensor,
                   bm: int, bn: int):
    """Per-tile dual checksums of an [..., m, n] array, ragged edges
    zero-padded.

    wm: [f, m], wn: [n, f].  Returns (ccol [..., ceil(m/bm), f, n], crow
    [..., ceil(n/bn), m, f]) — the carried-state layout of the accumulate
    kernel; used to (re)derive a consistent state from data, e.g. after a
    SUMMA failure recovery rebuilt C blocks.
    """
    *lead, m, n = c.shape
    f = wm.shape[0]
    pm, pn = _round_up(m, bm), _round_up(n, bn)
    mt, nt = pm // bm, pn // bn
    wmt, wnt = _tile_weights(_pad2(wm.float(), f, pm), _pad2(wn.float(), pn, f),
                             bm, bn)
    cc, cr = _tile_sums(_tiles(_pad2(c.float(), pm, pn), bm, bn), wmt, wnt)
    ccol = cc.transpose(-3, -2).reshape(*lead, mt, f, pn)[..., :n]
    crow = cr.transpose(-4, -3).reshape(*lead, nt, pm, f)[..., :m, :]
    return ccol.contiguous(), crow.contiguous()


def reduce_state(state, m: Optional[int] = None, n: Optional[int] = None):
    """Reduce a per-tile state to full checksums (cs_col [f,n], cs_row [m,f])."""
    ccol, crow = state
    cs_col = ccol.sum(dim=0)
    cs_row = crow.sum(dim=0)
    if n is not None:
        cs_col = cs_col[:, :n]
    if m is not None:
        cs_row = cs_row[:m, :]
    return cs_col, cs_row


def correct_from_state(c: torch.Tensor, state, wm: torch.Tensor,
                       wn: torch.Tensor, bm: int, bn: int, *,
                       tol_factor: float = 64.0):
    """PyTorch twin of the kernel's verify/correct prologue, on a full C.

    Locates a single corrupted element against the carried per-tile state
    (row via the row-direction residual, column via the column-direction
    residual) and repairs it by masked re-computation from the carried
    plain-sum column checksum.  Used for the post-loop scrub of the fused
    SUMMA path (a flip after the last accumulate has no next kernel call to
    catch it) and as the semantic oracle in tests.  A ragged C is zero-padded
    to the tiling, as the reference holds it.

    ``c`` may carry leading batch dims, [..., m, n] with a state of the same
    leading dims (ccol [..., mt, f, n], crow [..., nt, m, f]; wm and wn
    shared): every block is scaled, located and repaired on its own, as a
    call on that block alone would.  Nothing is read back to the host.
    Returns (fixed, detected: bool, corrected: bool, row: int64, col:
    int64), the last four of the batch shape (scalars for a 2-D C) — row/col
    are the located element (-1 when nothing was corrected).
    """
    *lead, m, n = c.shape
    f = wm.shape[0]
    pm, pn = _round_up(m, bm), _round_up(n, bn)
    mt = pm // bm
    ccol_c, crow_c = _pad_state(state, pm, pn)
    wm_p, wn_p = _pad2(wm.float(), f, pm), _pad2(wn.float(), pn, f)
    w0 = wm_p[0]
    # the carried plain-sum column checksums, one row of mt * pn a block
    carried_all = ccol_c[..., 0, :].reshape(*lead, mt * pn)
    # dtype-aware eps: fp32 floor (carried checksums are fp32 functions of
    # the rounded stored values), widened to the storage grid for bf16
    eps_c = detection_eps(c.dtype)
    c32 = _pad2(c.float(), pm, pn)
    c32 = c32.clone(memory_format=torch.contiguous_format) if c32 is c \
        else c32.contiguous()       # repaired in place below
    flat = c32.view(*lead, pm * pn)
    scale = c32.abs().mean(dim=(-2, -1)) + 1e-30
    tol_c = tol_factor * bm * eps_c * scale
    tol_r = tol_factor * bn * eps_c * scale
    cols, rows = torch.arange(pn, device=c.device), torch.arange(pm,
                                                                 device=c.device)
    seg_i = torch.arange(bm, device=c.device)
    detected = corrected = None
    loc_r = loc_c = None
    for it in range(2):
        ccol_now, crow_now = tile_checksums(c32, wm_p, wn_p, bm, bn)
        acol = (ccol_now - ccol_c)[..., 0, :].abs().sum(dim=-2)    # [..., pn]
        arow = (crow_now - crow_c)[..., 0].abs().sum(dim=-2)       # [..., pm]
        cmax, cidx = acol.amax(dim=-1), acol.argmax(dim=-1)
        rmax, ridx = arow.amax(dim=-1), arow.argmax(dim=-1)
        c2nd = torch.where(cols == cidx[..., None], 0.0, acol).amax(dim=-1)
        r2nd = torch.where(rows == ridx[..., None], 0.0, arow).amax(dim=-1)
        single = ((cmax > tol_c) & (rmax > tol_r)
                  & (c2nd <= torch.maximum(0.25 * cmax, tol_c))
                  & (r2nd <= torch.maximum(0.25 * rmax, tol_r)))
        if it == 0:
            detected = (cmax > tol_c) | (rmax > tol_r)
            corrected = single
            loc_r = torch.where(single, ridx, -1)
            loc_c = torch.where(single, cidx, -1)
        # masked re-computation from the carried column checksum of the
        # tile-row holding (ridx, cidx), gathered by index tensors
        tile_i = ridx // bm
        col = torch.gather(c32, -1, cidx[..., None, None].expand(
            *lead, pm, 1))[..., 0]                                 # [..., pm]
        at = (tile_i * bm)[..., None] + seg_i                      # [..., bm]
        seg = torch.where(at == ridx[..., None], 0.0,
                          torch.gather(col, -1, at))
        carried = torch.gather(carried_all, -1,
                               (tile_i * pn + cidx)[..., None])[..., 0]
        x_new = ((carried - (torch.take(w0, at) * seg).sum(dim=-1))
                 / (torch.take(w0, ridx) + 1e-30))
        old = torch.gather(col, -1, ridx[..., None])[..., 0]
        flat.scatter_(-1, (ridx * pn + cidx)[..., None],
                      torch.where(single, x_new, old)[..., None])
    if not c.dtype.is_floating_point:
        c32 = torch.round(c32)   # integer storage: snap the repair to grid
    return (c32[..., :m, :n].to(c.dtype), detected, corrected, loc_r, loc_c)


def _tile_verify_correct(c32, state, wm, wn, bm, bn, *, tol_factor,
                         eps_c: Optional[float] = None):
    """Vectorized-over-tiles twin of the kernel's verify/correct prologue.

    Exactly the math of ``csrc/abft_matmul_acc.cu``'s prologue (and of the
    reference's ``kernels.abft_matmul._verify_correct``), batched over the
    [mt, nt] tile grid of a zero-padded c32 [pm, pn] with the padded state
    ([mt, f, pn], [nt, pm, f]) and weights ([f, pm], [pn, f]): per-tile
    residuals vs the carried state, one concentration-gated repair PER TILE
    by masked re-computation from the carried plain-sum column checksum,
    two passes (the second only after a repair: a pass that repairs nothing
    leaves the tiles as they were).  Returns (fixed c32 [pm, pn], stats
    [mt, nt, STATS_WIDTH]).
    """
    ccol, crow = state
    pm, pn = c32.shape
    mt, nt = pm // bm, pn // bn
    f = wm.shape[0]
    eps_c = detection_eps(torch.float32) if eps_c is None else eps_c
    t = _tiles(c32, bm, bn)                                      # [mt,nt,bm,bn]
    wmt, wnt = _tile_weights(wm, wn, bm, bn)
    ccol_t = ccol.reshape(mt, f, nt, bn).permute(0, 2, 1, 3)     # [mt,nt,f,bn]
    crow_t = crow.reshape(nt, mt, bm, f).permute(1, 0, 2, 3)     # [mt,nt,bm,f]
    scale = t.abs().mean(dim=(2, 3)) + 1e-30                     # [mt,nt]
    tol_c = tol_factor * bm * eps_c * scale
    tol_r = tol_factor * bn * eps_c * scale
    dev = c32.device
    row_i = torch.arange(bm, device=dev)
    col_i = torch.arange(bn, device=dev)

    def take(arr, idx):
        return torch.gather(arr, -1, idx[..., None])[..., 0]

    stats = None
    for it in range(2):
        cc, cr = _tile_sums(t, wmt, wnt)
        ac = (cc - ccol_t)[:, :, 0, :].abs()                     # [mt,nt,bn]
        ar = (cr - crow_t)[:, :, :, 0].abs()                     # [mt,nt,bm]
        cmax, cidx = ac.max(-1).values, ac.argmax(-1)            # [mt,nt]
        rmax, ridx = ar.max(-1).values, ar.argmax(-1)
        c2 = torch.where(col_i == cidx[..., None], 0.0, ac).max(-1).values
        r2 = torch.where(row_i == ridx[..., None], 0.0, ar).max(-1).values
        detected = (cmax > tol_c) | (rmax > tol_r)
        single = ((cmax > tol_c) & (rmax > tol_r)
                  & (c2 <= torch.maximum(0.25 * cmax, tol_c))
                  & (r2 <= torch.maximum(0.25 * rmax, tol_r)))
        if it == 0:
            r_glob = torch.arange(mt, device=dev)[:, None] * bm + ridx
            c_glob = torch.arange(nt, device=dev)[None, :] * bn + cidx
            stats = torch.stack([
                detected.float(), single.float(),
                torch.where(single, r_glob.float(), -1.0),
                torch.where(single, c_glob.float(), -1.0),
                cmax, rmax, tol_c, scale,
            ], dim=-1)
        obs.tally("host_reads")
        if not bool(single.any()):
            break       # nothing repaired: a further pass finds the same
        mask = ((row_i[:, None] == ridx[..., None, None])
                & (col_i == cidx[..., None, None]))              # [mt,nt,bm,bn]
        masked = torch.where(mask, 0.0, t)
        s0 = torch.einsum("xb,xybn->xyn", wmt[:, 0, :], masked)  # [mt,nt,bn]
        num = take(ccol_t[:, :, 0, :], cidx) - take(s0, cidx)
        w0r = take(wmt[:, None, 0, :].expand(mt, nt, bm), ridx)
        x_new = num / (w0r + 1e-30)
        t = torch.where(single[..., None, None] & mask,
                        x_new[..., None, None], t)
    return t.permute(0, 2, 1, 3).reshape(pm, pn), stats


def _acc_twin(a, b, c_in, state, wm, wn, bm: int, bn: int, *, verify: bool,
              tol_factor: float, eps_c: Optional[float], out_dtype):
    """The accumulate step in plain PyTorch, state in the port's layout:
    the kernel's plain version and ``abft_matmul_acc(backend="torch")``.
    Returns (c_out, ccol, crow, stats), all new tensors."""
    m, n = c_in.shape
    f = wm.shape[0]
    pm, pn = _round_up(m, bm), _round_up(n, bn)
    if verify:
        c32, stats = _tile_verify_correct(
            _pad2(c_in.float(), pm, pn), _pad_state(state, pm, pn),
            _pad2(wm.float(), f, pm), _pad2(wn.float(), pn, f), bm, bn,
            tol_factor=tol_factor, eps_c=eps_c)
        c32 = c32[:m, :n]
    else:
        c32 = c_in.float()
        stats = torch.zeros((pm // bm, pn // bn, kmm.STATS_WIDTH),
                            dtype=torch.float32, device=c_in.device)
        stats[..., 2:4] = -1.0
    if a.dtype == torch.int8:
        # the kernel's int32 accumulator: the repaired tile rounded half to
        # even, plus the exact product (float64 holds every int8 dot)
        prod = torch.matmul(a.double(), b.double()).to(torch.int32)
        c_out = (torch.round(c32).to(torch.int32) + prod).to(out_dtype)
    else:
        c_out = torch.addmm(c32, a.float(), b.float()).to(out_dtype)
    ccol, crow = tile_checksums(c_out.float(), wm, wn, bm, bn)
    return c_out, ccol, crow, stats


def abft_matmul_acc(a: torch.Tensor, b: torch.Tensor, c_in: torch.Tensor,
                    state, *, plan: BlockPlan,
                    wm: Optional[torch.Tensor] = None,
                    wn: Optional[torch.Tensor] = None, verify: bool = True,
                    tol_factor: float = 64.0, out_dtype=None,
                    backend: str = "auto", out=None, planes=None):
    """C_out = C_in + A @ B with carried checksum state and fused scrub.

    ``state`` is the (ccol, crow) pair from ``acc_state_zeros`` or a prior
    call under the same ``plan``.  ``backend``: "cuda" runs the kernel (its
    plain version on a CPU tensor), "torch" the PyTorch twin (same
    semantics, separate ops), "auto" the kernel on a CUDA tensor and the
    twin on a CPU one.  On a CUDA tensor "auto" and "cuda" launch the kernel
    or raise.  A/B may be fp32, bf16 or int8 (int32 accumulation, integer
    C; repairs snap to the integer grid, so the int8 path stays bit-exact);
    the verify tolerance uses the dtype-aware ``detection_eps`` of the C
    storage dtype.  ``out = (c_out, ccol_out, crow_out)`` names where to
    write, and may be the inputs themselves (the kernel updates in place;
    the other paths copy their result there).  ``planes``, fp32 A's and B's
    3xTF32 planes (``kmm.tf32_planes``), are what the kernel's fp32
    tensor-core route reads; without them it splits A and B itself, and
    the other paths compute from A and B.
    Returns (c_out [m, n], new_state, stats [mt, nt, STATS_WIDTH]).
    """
    m, n = c_in.shape
    k = a.shape[1]
    out_dtype = out_dtype or c_in.dtype
    eps_c = detection_eps(c_in.dtype)
    f = KERNEL_F if wm is None else wm.shape[0]
    wm = kernel_weights(m, f, device=a.device) if wm is None else wm
    wn = kernel_weights(n, f, device=a.device).T if wn is None else wn
    if tuple(wn.shape) != (n, f):
        raise ValueError(f"wn shape {tuple(wn.shape)} != ({n}, {f})")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}: auto, cuda or torch")
    kernel = backend == "cuda" or (backend == "auto" and a.is_cuda)
    _publish_dispatch("abft_matmul_acc", m, k, n,
                      str(a.dtype).replace("torch.", ""),
                      ("cuda" if a.is_cuda else "plain") if kernel
                      else "torch")
    ccol_in, crow_in = state
    if kernel:
        c, ccol, crow, stats = kmm.abft_matmul_acc_cuda(
            a.contiguous(), b.contiguous(), c_in.contiguous(),
            ccol_in.contiguous(), crow_in.contiguous(),
            wm.float().contiguous(), wn.float().contiguous(), bm=plan.bm,
            bn=plan.bn, bk=plan.bk, verify=verify, tol_factor=tol_factor,
            eps_c=eps_c, out_dtype=out_dtype, out=out, planes=planes)
        return c, (ccol, crow), stats
    c, ccol, crow, stats = _acc_twin(
        a, b, c_in, state, wm, wn, plan.bm, plan.bn, verify=verify,
        tol_factor=tol_factor, eps_c=eps_c, out_dtype=out_dtype)
    if out is not None:
        for dst, src in zip(out, (c, ccol, crow)):
            dst.copy_(src)
        c, ccol, crow = out
    return c, (ccol, crow), stats


# ---------------------------------------------------------------------------
# Diskless-checkpoint encode
# ---------------------------------------------------------------------------


def checksum_encode(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Diskless-checkpoint encode: [p, m, n] x [f, p] -> [f, m, n] in
    x.dtype (fp32 sums over p, rounded once).

    A CUDA tensor launches kernel #3 or raises (fp32 and bf16 only); a CPU
    tensor runs its plain version.  The reference takes its Pallas kernel
    only when m and n are multiples of 128 and runs an einsum otherwise;
    the CUDA kernel masks nothing and pads nothing (a flat walk over the
    m * n columns), so every shape takes it."""
    p, m, n = x.shape
    a = a.to(device=x.device, dtype=torch.float32).contiguous()
    _publish_dispatch("checksum_encode", m, p, n,
                      str(x.dtype).replace("torch.", ""),
                      "cuda" if x.is_cuda else "plain")
    return kenc.checksum_encode_cuda(x.contiguous(), a)

"""ABFT SUMMA matrix-matrix multiplication (paper §2.2, §3, Fig. 1) on one
device, with the P x P process grid stacked on it.

The paper's algorithm, as the reference package's ``repro/core/summa.py``
maps it to a device mesh, with the mesh replaced by a stacked grid:

  * The grid is P x P blocks, held contiguously as [P, P, mb, nb] (one block
    per process of the paper).  The *data* occupies the leading (P-f) x (P-f)
    sub-grid; the last f grid rows hold the checksum blocks of A and C
    (Cc^T A), the last f grid cols hold the checksum blocks of B and C
    (B Cr) — the paper's "(2p-1) of p^2 processes are dedicated to fault
    tolerance" layout (f=1).

  * SUMMA outer-product schedule: at step k, column k of A's blocks is
    copied into a contiguous [P, mb, kb] panel and row k of B's blocks is
    the [P, kb, nb] panel — the broadcasts of the reference's masked psums
    along grid rows and columns — then every block (r, c) takes the rank-kb
    update C[r, c] += A_panel[r] @ B_panel[c].  Because the schedule is
    outer-product, EVERY intermediate C_k is checksum-consistent, which is
    the paper's key contribution: a failure at any step is recoverable
    without rollback.

  * Failure: ``FailureEvent(step, row, col)`` erases the A, B and partial-C
    blocks of one process mid-loop.  Recovery (paper §3.3) happens in-line:
    weighted sums along the surviving line rebuild the lost blocks
    (T_checksum, the MPI_Reduce analogue), then the loop continues.

  * Local update: ``local_update="auto"`` on a CUDA tensor (or "cuda") runs
    every rank-kb update through the fused accumulate kernel
    (``kernels.ops.abft_matmul_acc``): each block's checksum state is kept
    by the kernel's epilogue and, under an encoding, its verify/correct
    prologue scrubs a silently-corrupted C element at the NEXT step (plus a
    post-loop scrub for a last-step flip).  A run makes P steps x P^2
    launches.  "torch" (and "auto" on a CPU tensor) is the plain batched
    ``torch.matmul`` update; "cuda" on a CPU tensor runs the kernel's plain
    version.

Failure coordinates are static, as in the reference (recovery follows
failure detection, mirroring FT-MPI's out-of-band restart).  The
``torch.distributed`` grid comes with the distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.encoding import (EncodingSpec, encode_block_cols,
                                       encode_block_rows)

__all__ = ["FailureEvent", "MultiFailureEvent", "BitflipEvent",
           "abft_summa", "summa", "encode_operands"]


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """Erase process (row, col)'s blocks after `step` SUMMA steps."""
    step: int
    row: int
    col: int


@dataclasses.dataclass(frozen=True)
class MultiFailureEvent:
    """Erase SEVERAL processes simultaneously after `step` SUMMA steps.

    Recoverable iff, per grid column, at most f processes fail (A/C recover
    along columns via cc) AND, per grid row, at most f fail (B recovers
    along rows via cr) — the in-flight analogue of the paper's f-failure
    condition.
    """
    step: int
    devices: Tuple[Tuple[int, int], ...]

    def check(self, f: int):
        by_col: dict = {}
        by_row: dict = {}
        for (r, c) in self.devices:
            by_col.setdefault(c, []).append(r)
            by_row.setdefault(r, []).append(c)
        if any(len(v) > f for v in by_col.values()):
            raise ValueError(f"more than f={f} failures in one grid column")
        if any(len(v) > f for v in by_row.values()):
            raise ValueError(f"more than f={f} failures in one grid row")
        return by_col, by_row


@dataclasses.dataclass(frozen=True)
class BitflipEvent:
    """Corrupt one element of the partial C of process (row,col) after `step`."""
    step: int
    row: int
    col: int
    delta: float = 1.0e3


def encode_operands(a: torch.Tensor, b: torch.Tensor, spec: EncodingSpec):
    """Row-encode A ([M,K] -> [M+f*mb,K]) and col-encode B ([K,N] -> [K,N+f*nb]).

    Checksum granularity is the process grid (one block per process), so the
    encoded matrices gain f full block rows / cols.
    """
    return encode_block_rows(a, spec.cc), encode_block_cols(b, spec.cr)


def _solve_static(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b for a tiny k x k system (k failed lines, <= f):
    closed forms for k <= 2, unrolled Gauss-Jordan with partial pivoting
    beyond — the reference's solver, in fp32."""
    k = a.shape[0]
    a = a.float()
    b = b.float()
    if k == 1:
        return b / a[0, 0]
    if k == 2:
        det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        return torch.stack([(a[1, 1] * b[0] - a[0, 1] * b[1]) / det,
                            (a[0, 0] * b[1] - a[1, 0] * b[0]) / det])
    aug = torch.cat([a, b], dim=1)
    for col in range(k):
        piv = int(aug[col:, col].abs().argmax()) + col
        aug[[col, piv]] = aug[[piv, col]]
        aug = aug / torch.where(torch.arange(k, device=aug.device) == col,
                                aug[col, col], 1.0)[:, None]
        aug = aug - torch.where(torch.arange(k, device=aug.device) == col,
                                0.0, aug[:, col])[:, None] * aug[col][None]
    return aug[:, k:]


def _to_blocks(x: torch.Tensor, grid: int) -> torch.Tensor:
    """[grid*mb, grid*nb] -> a new contiguous [grid, grid, mb, nb]."""
    h, w = x.shape
    return x.reshape(grid, h // grid, grid, w // grid).permute(
        0, 2, 1, 3).contiguous()


def _from_blocks(x: torch.Tensor) -> torch.Tensor:
    g0, g1, mb, nb = x.shape
    return x.permute(0, 2, 1, 3).reshape(g0 * mb, g1 * nb)


def _recover_line(x: torch.Tensor, weights: torch.Tensor, grid: int,
                  fail_lines, fail_perp: int, *, axis: int, f: int) -> None:
    """Rebuild, in place, the blocks at (fail_lines x {fail_perp}) of the
    stacked grid x [grid, grid, mb, nb] from the line's checksums — a joint
    |failed-data| x |failed-data| solve (paper §2.1).

    ``axis=0``: the line is grid column ``fail_perp`` and runs over rows (A
    and C, with cc); ``axis=1``: the line is grid row ``fail_perp`` and runs
    over columns (B, with cr).  Data indices are [0, p_data), checksum j
    lives at index p_data + j and holds sum_i weights[j, i] * x_i.  Only the
    checksum slots whose blocks SURVIVED are used; lost checksum blocks are
    recomputed from the restored data afterwards.
    """
    p_data = grid - f
    w32 = weights.float()                                   # [f, p_data]
    line = x[:, fail_perp] if axis == 0 else x[fail_perp]   # view [grid, mb, nb]
    failed_data = [l for l in fail_lines if l < p_data]
    failed_cs = [l for l in fail_lines if l >= p_data]

    if failed_data:
        k = len(failed_data)
        ok = [i for i in range(p_data) if i not in fail_lines]
        # a failed checksum block holds zeros: its equation is unusable
        avail = [j for j in range(f) if (p_data + j) not in fail_lines][:k]
        assert len(avail) == k, "not enough surviving checksums in line"
        x32 = line.float()
        # rhs_j = y_j - sum_ok w[j,i] x_i
        rhs = x32[[p_data + j for j in avail]] - torch.einsum(
            "fp,p...->f...", w32[avail][:, ok], x32[ok])
        sub = w32[avail][:, failed_data]                    # [k, k]
        sol = _solve_static(sub, rhs.reshape(k, -1)).reshape(
            (k,) + tuple(line.shape[1:]))
        for i, l in enumerate(failed_data):
            line[l] = sol[i].to(x.dtype)

    if failed_cs:
        # recompute lost checksum blocks from the (now restored) data
        x32 = line[:p_data].float()
        for l in failed_cs:
            line[l] = torch.einsum("p,p...->...", w32[l - p_data],
                                   x32).to(x.dtype)


def _resolve_local_update(local_update: str, mb: int, kb: int, nb: int,
                          dtype, device: torch.device):
    """Map a `local_update` request to the kernel's BlockPlan, or None for
    the plain ``torch.matmul`` update.

    "cuda" (and "auto" on a CUDA tensor) runs the accumulate kernel.  The
    carried checksum state lives across the whole SUMMA loop, so an exact
    tiling of the local blocks is preferred (``require_exact``); the kernel
    masks ragged edges, so where none exists the best ragged tiling runs.
    """
    from repro_torch.kernels import autotune as ktune  # lazy: core <-> kernels

    if local_update == "torch" or (local_update == "auto"
                                   and device.type != "cuda"):
        return None
    if local_update not in ("auto", "cuda"):
        raise ValueError(f"unknown local_update {local_update!r}: auto, cuda "
                         "or torch")
    # best_plan resolves a measured winner (env override or warmed cache)
    # where one exists and the time model otherwise; it never measures
    kw = dict(in_dtype=dtype, carry=True, device=device)
    plan = (ktune.best_plan(mb, kb, nb, require_exact=True, **kw)
            or ktune.best_plan(mb, kb, nb, **kw))
    if plan is None:
        raise ValueError(f"no tiling of the local blocks ({mb},{kb},{nb})")
    return plan


def _local_summa(a_blk, b_blk, *, grid: int, spec: Optional[EncodingSpec],
                 failure, bitflip: Optional[BitflipEvent], preferred_dtype,
                 plan=None, on_stats: Optional[Callable] = None):
    """SUMMA over the stacked grid: a_blk [P, P, mb, kb], b_blk
    [P, P, kb, nb] (private copies, updated in place by failures) ->
    (C blocks [P, P, mb, nb] fp32, the carried kernel state (ccol
    [P, P, ...], crow [P, P, ...]) or None on the plain update)."""
    from repro_torch.kernels import ops as kops  # lazy: core <-> kernels

    dev = a_blk.device
    mb, kb = a_blk.shape[2], a_blk.shape[3]
    nb = b_blk.shape[3]
    fused = plan is not None
    # The plain (non-FT) SUMMA baseline must not pay the per-step scrub nor
    # be able to rewrite its own accumulator — verify only under an ABFT
    # encoding (spec), where the scrub is the point.
    fused_verify = fused and spec is not None
    c_blk = torch.zeros((grid, grid, mb, nb), dtype=torch.float32, device=dev)
    if fused:
        wm = kops.kernel_weights(mb, device=dev)
        wn = kops.kernel_weights(nb, device=dev).T.contiguous()
        ccol0, crow0 = kops.acc_state_zeros(plan, device=dev)
        ccol = torch.zeros((grid, grid) + tuple(ccol0.shape),
                           dtype=torch.float32, device=dev)
        crow = torch.zeros((grid, grid) + tuple(crow0.shape),
                           dtype=torch.float32, device=dev)

    def step(k):
        # the broadcasts: column k of A's blocks, row k of B's blocks
        a_panel = a_blk[:, k].to(preferred_dtype).contiguous()  # [P, mb, kb]
        b_panel = b_blk[k].to(preferred_dtype).contiguous()     # [P, kb, nb]
        if not fused:
            c_blk.add_(torch.matmul(a_panel.float().unsqueeze(1),
                                    b_panel.float().unsqueeze(0)))
            return
        for r in range(grid):
            for c in range(grid):
                # rank-kb update through the fused kernel, in place: the
                # checksum state is kept (and C_in scrubbed) in the same pass
                _, _, stats = kops.abft_matmul_acc(
                    a_panel[r], b_panel[c], c_blk[r, c],
                    (ccol[r, c], crow[r, c]), plan=plan, wm=wm, wn=wn,
                    verify=fused_verify, out_dtype=torch.float32,
                    backend="cuda",
                    out=(c_blk[r, c], ccol[r, c], crow[r, c]))
                if on_stats is not None:
                    on_stats(k, r, c, stats)

    events = []
    if failure is not None:
        events.append(("fail", failure))
    if bitflip is not None:
        events.append(("flip", bitflip))
    events.sort(key=lambda e: e[1].step)

    k0 = 0
    for kind, ev in events:
        for k in range(k0, ev.step):
            step(k)
        k0 = ev.step
        if kind == "fail":
            assert spec is not None, "failure injection requires an encoding"
            devices = (ev.devices if isinstance(ev, MultiFailureEvent)
                       else ((ev.row, ev.col),))
            by_col: dict = {}
            by_row: dict = {}
            for (r, c) in devices:
                by_col.setdefault(c, []).append(r)
                by_row.setdefault(r, []).append(c)
            # --- the failure: these processes' state is gone -------------
            for (r, c) in devices:
                a_blk[r, c].zero_()
                b_blk[r, c].zero_()
                c_blk[r, c].zero_()
            # --- T_checksum: rebuild from the weighted checksums ---------
            # A and the partial C recover along columns (cc checksums);
            # B recovers along rows (cr) — per line, a joint f-way solve.
            for col, rows in by_col.items():
                _recover_line(a_blk, spec.cc, grid, rows, col, axis=0,
                              f=spec.f)
                _recover_line(c_blk, spec.cc, grid, rows, col, axis=0,
                              f=spec.f)
            for row, cols in by_row.items():
                _recover_line(b_blk, spec.cr, grid, cols, row, axis=1,
                              f=spec.f)
            if fused:
                # the kernel-level checksum state predates the rebuild (the
                # recovered blocks carry fresh rounding) — re-derive it from
                # the recovered C so the next fused step doesn't misread the
                # recovery noise as corruption
                for r in range(grid):
                    for c in range(grid):
                        ccol[r, c], crow[r, c] = kops.tile_checksums(
                            c_blk[r, c], wm, wn, plan.bm, plan.bn)
        else:  # bit-flip: silent corruption of one partial-sum element
            c_blk[ev.row, ev.col, 0, 0] += ev.delta

    for k in range(k0, grid):
        step(k)
    if fused_verify:
        # post-loop scrub: a flip after the last accumulate has no next
        # kernel call to catch it; the state-vs-C residual repairs it here
        for r in range(grid):
            for c in range(grid):
                c_blk[r, c] = kops.correct_from_state(
                    c_blk[r, c], (ccol[r, c], crow[r, c]), wm, wn, plan.bm,
                    plan.bn)[0]
    return c_blk, ((ccol, crow) if fused else None)


def abft_summa(a_enc: torch.Tensor, b_enc: torch.Tensor, grid: int, *,
               spec: EncodingSpec, failure=None,
               bitflip: Optional[BitflipEvent] = None,
               preferred_dtype=torch.float32, local_update: str = "auto",
               on_stats: Optional[Callable] = None) -> torch.Tensor:
    """Fault-tolerant matmul of encoded operands on a grid x grid process
    grid stacked on the operands' device.

    a_enc: [M + f*mb, K] row-encoded; b_enc: [K, N + f*nb] col-encoded,
    both divisible into grid x grid blocks.  Returns the fully-encoded
    product C_F = [M+f*mb, N+f*nb] (Eq. 1), fp32.  ``failure`` is a
    ``FailureEvent`` or ``MultiFailureEvent``.  ``local_update`` selects the
    per-step rank-kb update (module docstring).  ``on_stats(step, row, col,
    stats)``, when given, sees the stats of every kernel launch.
    """
    plan = _resolve_local_update(
        local_update, a_enc.shape[0] // grid, a_enc.shape[1] // grid,
        b_enc.shape[1] // grid, preferred_dtype, a_enc.device)
    c_blk, _ = _local_summa(
        _to_blocks(a_enc, grid), _to_blocks(b_enc, grid), grid=grid,
        spec=spec, failure=failure, bitflip=bitflip,
        preferred_dtype=preferred_dtype, plan=plan, on_stats=on_stats)
    return _from_blocks(c_blk)


def summa(a: torch.Tensor, b: torch.Tensor, grid: int, *,
          preferred_dtype=torch.float32,
          local_update: str = "auto") -> torch.Tensor:
    """Plain (non-FT) SUMMA — the paper's PBLAS PDGEMM baseline."""
    plan = _resolve_local_update(
        local_update, a.shape[0] // grid, a.shape[1] // grid,
        b.shape[1] // grid, preferred_dtype, a.device)
    c_blk, _ = _local_summa(
        _to_blocks(a, grid), _to_blocks(b, grid), grid=grid, spec=None,
        failure=None, bitflip=None, preferred_dtype=preferred_dtype,
        plan=plan)
    return _from_blocks(c_blk)

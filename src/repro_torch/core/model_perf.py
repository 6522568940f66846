"""The paper's alpha-beta-gamma performance model (§3, Eqs. 2-9).

Conventions follow §3.1 as *used* (the prose swaps alpha/beta; the algebra
does not):  `alpha` = per-message latency [s], `beta` = per-element transfer
time [s/element] (inverse bandwidth x element size), `gamma` = per-flop time
[s/flop].  Matrices are n-by-n on a sqrt(p)-by-sqrt(p) grid.

Paper machine constants (jacquard.nersc.gov, §4.2):
  flop rate 3.75 GFLOP/s  ->  gamma = 1/3.75e9
  bandwidth 52.5 MB/s     ->  beta  = 8 / 52.5e6   (double precision)
  latency 4.5 us          ->  alpha = 4.5e-6  (neglected by the paper; kept)

`predict_*` return times in seconds; `gflops_per_proc` converts to the
paper's reported metric (useful flops 2 n_data^3 over ALL p processors —
checksum processors count in the denominator, which is exactly why ABFT
efficiency *rises* with p: (2p-1)/p^2 -> 0).

A copy of the reference package's ``repro/core/model_perf.py``: plain
arithmetic, no arrays, so nothing here runs on a device.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["Machine", "JACQUARD", "pdgemm_time", "abft_pdgemm_time",
           "abft_failure_overhead", "gflops_per_proc", "weak_scaling_table"]


@dataclasses.dataclass(frozen=True)
class Machine:
    gamma: float           # s / flop
    beta: float            # s / element (8-byte doubles)
    alpha: float = 0.0     # s / message
    name: str = "machine"


JACQUARD = Machine(gamma=1 / 3.75e9, beta=8 / 52.5e6, alpha=4.5e-6,
                   name="jacquard.nersc.gov")


def pdgemm_time(n: int, p: int, m: Machine, nb: int = 64) -> float:
    """Eq. (6): PBLAS PDGEMM (ring-pipelined SUMMA) runtime.

    2 n^2 (n+1) / p * gamma  +  2 (n + 2 sqrt(p) - 3)(alpha + n/sqrt(p) beta)

    The message count `n` in the second term is element-granular (the paper
    absorbed the blocking factor); alpha is applied per nb-wide panel.
    """
    q = math.isqrt(p)
    assert q * q == p, "square process grids only (paper §4.2)"
    t_comp = 2 * n * n * (n + 1) / p * m.gamma
    n_msgs = (n / nb) + 2 * q - 3          # pipeline depth in panel units
    t_comm = 2 * (n + 2 * q - 3) * (n / q) * m.beta + 2 * n_msgs * m.alpha
    return t_comp + t_comm


def abft_pdgemm_time(nloc: int, p: int, m: Machine, nb: int = 64) -> float:
    """Eq. (9): ABFT PDGEMM (0 failures) on a q-by-q grid, p = q^2 total procs.

    Data is n = (q-1)*nloc; encoded size N = n + nloc = q*nloc.  The multiply
    is (n+nloc) x n x (n+nloc); the pipe is one block row/col longer.
    """
    q = math.isqrt(p)
    assert q * q == p
    n = (q - 1) * nloc
    n_enc = q * nloc
    t_comp = 2 * n_enc * n_enc * n / p * m.gamma
    n_msgs = (n / nb) + 2 * q - 3
    t_comm = 2 * (n + 2 * q - 3) * (n_enc / q) * m.beta + 2 * n_msgs * m.alpha
    return t_comp + t_comm


def abft_failure_overhead(
    nloc: int, p: int, m: Machine, nb: int = 64,
    t_restart_base: float = 0.6, t_restart_per_proc: float = 0.012,
) -> float:
    """§3.3: T_detection + T_restart + T_pushdata + T_checksum (1 failure).

    * detection  ~ one local DGEMM panel update (the unnotified process
      finishes its in-flight rank-nb update): 2 * (N/q)^2 * nb * gamma
    * restart    ~ FT-MPI respawn; depends only on total process count
      (paper §3.3) — affine model calibrated on the paper's two endpoints.
    * pushdata   ~ fill + empty the pipe once: 2 q (alpha + (N/q) nb beta)
    * checksum   ~ MPI_Reduce of an nloc^2 block over a column:
      log2(q) * nloc^2 * beta
    """
    q = math.isqrt(p)
    n_enc = q * nloc
    mloc = n_enc / q
    t_detect = 2 * mloc * mloc * nb * m.gamma
    t_restart = t_restart_base + t_restart_per_proc * p
    t_pushdata = 2 * q * (m.alpha + mloc * nb * m.beta)
    t_checksum = math.log2(q) * nloc * nloc * m.beta
    return t_detect + t_restart + t_pushdata + t_checksum


def gflops_per_proc(n_data: int, p: int, t: float) -> float:
    """Paper's reported metric: useful GFLOPS/s/proc = 2 n^3 / (p T) / 1e9."""
    return 2 * n_data**3 / (p * t) / 1e9


def weak_scaling_table(nloc: int, grids, m: Machine = JACQUARD, nb: int = 64):
    """Reproduce Table 1's model columns for grid sizes `grids` (e.g. 8..22).

    Returns rows: (p, pblas, abft0, abft1) in GFLOPS/s/proc.
    """
    rows = []
    for q in grids:
        p = q * q
        n_full = q * nloc
        t_pblas = pdgemm_time(n_full, p, m, nb)
        pblas = gflops_per_proc(n_full, p, t_pblas)
        n_data = (q - 1) * nloc
        t0 = abft_pdgemm_time(nloc, p, m, nb)
        abft0 = gflops_per_proc(n_data, p, t0)
        t1 = t0 + abft_failure_overhead(nloc, p, m, nb)
        abft1 = gflops_per_proc(n_data, p, t1)
        rows.append((p, pblas, abft0, abft1))
    return rows

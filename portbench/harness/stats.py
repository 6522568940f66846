"""Percentiles, and the FLOP and byte counts the readers share.

Every count is of the algorithm's work at the shapes the configuration and
the traffic give, never of what a kernel happens to launch: a kernel that
does more than the work needs reads a lower share, not a higher one.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["percentile", "median", "gemm_work", "roofline_share", "peak"]


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100), linear between the closest ranks (as
    numpy's default); None for no samples."""
    xs = sorted(xs)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(xs: Sequence[float]) -> Optional[float]:
    return percentile(xs, 50.0)


def gemm_work(m: int, k: int, n: int, in_bytes: int, out_bytes: int,
              acc: bool = False):
    """(FLOPs, bytes) of C[m, n] (+)= A[m, k] @ B[k, n]: each input read
    once, the output written once (and read once where it accumulates)."""
    flops = 2.0 * m * k * n
    nbytes = (m * k + k * n) * in_bytes + m * n * out_bytes * (2 if acc
                                                                else 1)
    return flops, float(nbytes)


def peak(ctx, unit: str) -> Optional[float]:
    """The published peak ``unit`` of the run's device, or None off the
    table (a CPU run has none)."""
    row = ctx.peaks.get(ctx.device_kind)
    return None if row is None else row.get(unit)


def roofline_share(ctx, flops: float, nbytes: float, pattern: str,
                   compute_peak: str) -> Optional[float]:
    """100 x (least time: the larger of FLOPs over the compute peak and
    bytes over the bandwidth) / (device time of the kernels matching
    ``pattern``); None without a trace, a peak or such a kernel."""
    if ctx.trace is None or flops <= 0:
        return None
    fl, bw = peak(ctx, compute_peak), peak(ctx, "hbm_bytes_per_s")
    spent = ctx.trace.seconds_matching(pattern)
    if fl is None or bw is None or not spent:
        return None
    return 100.0 * max(flops / fl, nbytes / bw) / spent

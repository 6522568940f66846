"""Iterative solvers protected by algorithm-level redundancy.

The second protected algorithm family (the first is the transformer
train/serve step): a conjugate-gradient solver whose preconditioner is a
redundant subspace correction (arXiv 1309.0212) — overlapping subspaces
with redundant worker copies, so a lost component is *continued through*
by re-weighting the surviving corrections instead of rolling back.  The
chaos campaign drills it as the ``"solver"`` workload with the same fault
kinds as train/serve (sdc, dram, shard/pod loss).
"""
from repro_torch.solvers.subspace_cg import (GuardTrip, RedundantSubspaceCG,
                                             SolveReport, SolverConfig,
                                             Worker, poisson_1d)

__all__ = ["SolverConfig", "RedundantSubspaceCG", "SolveReport",
           "GuardTrip", "Worker", "poisson_1d"]

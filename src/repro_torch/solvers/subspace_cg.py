"""Error-resilient CG via redundant subspace correction (arXiv 1309.0212).

The second protected algorithm family in the chaos matrix.  A flexible
conjugate-gradient solve of an SPD system (1D Poisson by default) is
preconditioned by *redundant subspace correction*: the index space is cut
into overlapping blocks (each unknown covered by exactly two blocks, in a
wrap-around layout), every block's local solve is replicated across
``replicas`` workers placed on simulated pods, and the global correction
is the partition-of-unity weighted sum of the surviving block solves.

The fault-tolerance story is **continue-through, not rollback**:

* a lost worker whose sister replica survives is a pure failover — the
  replicas compute the same correction, so the iterate is untouched
  (rung ``solver:failover``);
* a subspace whose workers are ALL dead is dropped and the
  partition-of-unity weights are renormalized over the surviving cover —
  the preconditioner changes mid-solve, so the direction is restarted
  FCG-style (``p = z``) and CG converges through on the degraded
  preconditioner (rung ``solver:reweight``);
* an SDC in one replica's correction is caught by the per-subspace
  local-solve residual check (``||A_ii c - r_i||`` — the correction must
  solve its own block system) and repaired from the sister replica, or
  recomputed when no clean replica remains (rung
  ``solver:replica_repair`` / ``solver:local_recompute``);
* a DRAM flip in the resident iterate is caught by the residual-norm
  monotonicity guard on the *explicit* residual ``||b - A x||`` (NaN
  normalized to +inf before thresholding); the guard sanitizes the
  iterate, recomputes the residual from scratch and restarts the
  direction — the perturbed iterate is kept and CG converges through it
  (rung ``solver:guard_restart``).

No checkpoint is ever taken and no iterate is ever restored: every
repair is forward.

The counterpart of the reference package's ``repro/solvers/subspace_cg.py``.
The operator, the right-hand side, the iterate, residual and direction,
the diagonal blocks and their inverses are float64 tensors on the solver's
device; the topology (workers, pods), the trip logs and the report stay on
the host, and each norm or residual the guards compare is read back once.
Every operation is deterministic on the device, so a drill that repairs
exactly (a replica repair, a failover) ends bit-identical to the clean
solve on the same device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.chaos.faults import register_surface

__all__ = ["SolverConfig", "RedundantSubspaceCG", "SolveReport",
           "GuardTrip", "Worker", "poisson_1d"]

register_surface(
    "solvers.subspace_cg/correction_sum",
    owner="repro_torch.solvers.subspace_cg",
    protected=True,
    promise="tolerance",
    detector=("per-subspace local-solve residual check across redundant "
              "replicas (||A_ii c - r_i||); repair = sister replica or "
              "local recompute"),
    kinds=("sdc_collective",),
)
register_surface(
    "solvers.subspace_cg/iterate_at_rest",
    owner="repro_torch.solvers.subspace_cg",
    protected=True,
    promise="tolerance",
    detector=("residual-norm monotonicity guard on the explicit "
              "||b - A x|| (NaN normalized to +inf); sanitize + FCG "
              "restart, no rollback"),
    kinds=("dram_params",),
)
register_surface(
    "solvers.subspace_cg/subspaces",
    owner="repro_torch.solvers.subspace_cg",
    protected=True,
    promise="tolerance",
    detector=("platform signal; redundant replicas fail over, "
              "partition-of-unity re-weighted on subspace death"),
    kinds=("shard_loss", "pod_loss"),
)

_F64 = torch.float64


def poisson_1d(n: int, seed: int = 0, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1D Poisson stiffness matrix and a seeded right-hand side, float64 on
    ``device``.  The tridiagonal is written in place (its entries are
    exact integers: the reference's values, without its three dense
    temporaries); ``x_true`` is ``RandomState(seed)``'s draw, as there."""
    a = torch.zeros((n, n), dtype=_F64, device=device)
    a.diagonal().fill_(2.0)
    a.diagonal(1).fill_(-1.0)
    a.diagonal(-1).fill_(-1.0)
    x_true = np.random.RandomState(seed).standard_normal(n)
    return a, a @ torch.from_numpy(x_true).to(device)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    n: int = 96
    n_subspaces: int = 12
    replicas: int = 2
    pods: int = 3
    placement: str = "anti"     # "anti": replicas on distinct pods;
                                # "paired": both replicas share a pod
    rtol: float = 1e-10
    max_iters: int = 500
    guard_factor: float = 10.0  # explicit-residual growth that trips
    local_tol: float = 1e-8     # block-solve residual check threshold
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n % self.n_subspaces:
            raise ValueError("n must divide evenly into n_subspaces")
        if self.placement not in ("anti", "paired"):
            raise ValueError(f"unknown placement {self.placement!r}")
        if self.replicas < 1 or self.pods < 2:
            raise ValueError("need >=1 replica and >=2 pods")


@dataclasses.dataclass
class Worker:
    subspace: int
    replica: int
    pod: int
    alive: bool = True


@dataclasses.dataclass(frozen=True)
class GuardTrip:
    iteration: int
    kind: str          # "guard_restart" | "replica_repair" | "local_recompute"
    detail: str
    residual_before: float
    residual_after: float


@dataclasses.dataclass(frozen=True)
class SolveReport:
    converged: bool
    iterations: int
    residual_norm: float
    rtol: float
    trips: Tuple[GuardTrip, ...]
    failovers: Tuple[str, ...]
    reweights: Tuple[str, ...]
    dead_subspaces: Tuple[int, ...]

    @property
    def rungs(self) -> Tuple[str, ...]:
        out = ["solver:" + t.kind for t in self.trips]
        out += ["solver:failover"] * len(self.failovers)
        out += ["solver:reweight"] * len(self.reweights)
        return tuple(out)


_SANITIZE_CLAMP = 1e8   # |x_j| beyond this is declared corrupt and zeroed


def _finite_or_inf(v: float) -> float:
    return v if math.isfinite(v) else math.inf


class RedundantSubspaceCG:
    """FCG on an SPD system with a redundant-subspace-correction M^{-1},
    its arrays on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: SolverConfig = SolverConfig(), device="cuda"):
        from repro_torch.launch.serve import resolve_device
        self.cfg = cfg
        self.device = resolve_device(str(device))
        self.a, self.b = poisson_1d(cfg.n, seed=cfg.seed, device=self.device)
        self.bnorm = float(torch.linalg.norm(self.b))
        h = cfg.n // cfg.n_subspaces
        # Wrap-around blocks of width 2h, stride h: every index is covered
        # by exactly two subspaces, so no single subspace death (nor any
        # non-adjacent set of deaths) leaves an unknown uncovered.  Within
        # a block the indices are distinct (2h <= n), so one index_add_
        # per block adds each entry once.
        self.blocks: List[torch.Tensor] = [
            (torch.arange(2 * h, device=self.device) + i * h) % cfg.n
            for i in range(cfg.n_subspaces)
        ]
        # the diagonal blocks A_ii, kept for the local residual check
        self.block_a = [self.a[ix[:, None], ix[None, :]] for ix in self.blocks]
        self.block_inv = [torch.linalg.inv(ai) for ai in self.block_a]
        self.workers: List[Worker] = []
        for i in range(cfg.n_subspaces):
            for rep in range(cfg.replicas):
                if cfg.placement == "anti":
                    pod = (i + rep) % cfg.pods
                else:
                    pod = i % cfg.pods
                self.workers.append(Worker(i, rep, pod))
        # Live solve state (continue-through: never checkpointed).
        self.x = torch.zeros(cfg.n, dtype=_F64, device=self.device)
        self.r = self.b.clone()
        self.z: Optional[torch.Tensor] = None
        self.p: Optional[torch.Tensor] = None
        self.rz = 0.0
        self.rn_explicit = self.bnorm
        self.iteration = 0
        self.trips: List[GuardTrip] = []
        self.failovers: List[str] = []
        self.reweights: List[str] = []
        self._pending_sdc: List[Tuple[int, int, int, float]] = []
        self._pending_kills: List[Tuple[int, int]] = []
        self._weights = self._partition_of_unity()

    def nbytes(self) -> int:
        """Bytes the solver holds on its device (operator, blocks, their
        inverses and the solve vectors)."""
        ts = [self.a, self.b, self.x, self.r, *self.block_a,
              *self.block_inv, *self.blocks]
        ts += [t for t in (self.z, self.p) if t is not None]
        ts += [w for w in self._weights if w is not None]
        return sum(t.numel() * t.element_size() for t in ts)

    # ---------------------------------------------------------------- topology

    def alive_workers(self, subspace: int) -> List[Worker]:
        return [w for w in self.workers
                if w.subspace == subspace and w.alive]

    def alive_subspaces(self) -> List[int]:
        return [i for i in range(self.cfg.n_subspaces)
                if self.alive_workers(i)]

    def dead_subspaces(self) -> List[int]:
        return [i for i in range(self.cfg.n_subspaces)
                if not self.alive_workers(i)]

    def coverage(self) -> torch.Tensor:
        cover = torch.zeros(self.cfg.n, dtype=_F64, device=self.device)
        for i in self.alive_subspaces():
            cover[self.blocks[i]] += 1.0
        return cover

    def _partition_of_unity(self) -> List[Optional[torch.Tensor]]:
        """Per-subspace scatter weights: 1 / (alive blocks covering j)."""
        cover = self.coverage()
        n_void = int((cover == 0).sum())
        if n_void:
            raise RuntimeError(
                f"unrecoverable: {n_void} unknowns uncovered "
                f"(dead subspaces {self.dead_subspaces()})")
        weights: List[Optional[torch.Tensor]] = []
        for i in range(self.cfg.n_subspaces):
            if self.alive_workers(i):
                weights.append(1.0 / cover[self.blocks[i]])
            else:
                weights.append(None)
        return weights

    def lose_worker(self, subspace: int, replica: int,
                    mid_iteration: bool = False) -> Dict[str, object]:
        """Kill one worker.  With ``mid_iteration`` the kill is delivered
        inside the next :meth:`iterate`, after local corrections are
        computed but before they are summed — the surviving corrections
        are re-weighted on the fly and the iteration completes."""
        if mid_iteration:
            self._pending_kills.append((subspace, replica))
            return {"queued": True, "subspace": subspace, "replica": replica}
        return self._kill(subspace, replica)

    def _kill(self, subspace: int, replica: int) -> Dict[str, object]:
        for w in self.workers:
            if w.subspace == subspace and w.replica == replica and w.alive:
                w.alive = False
                break
        else:
            return {"killed": False, "subspace": subspace, "replica": replica}
        survivors = self.alive_workers(subspace)
        if survivors:
            self.failovers.append(f"s{subspace}r{replica}")
            return {"killed": True, "subspace": subspace,
                    "replica": replica, "rung": "solver:failover"}
        self.reweights.append(f"s{subspace}")
        self._weights = self._partition_of_unity()
        self.p = None    # preconditioner changed: FCG restart next iterate
        return {"killed": True, "subspace": subspace,
                "replica": replica, "rung": "solver:reweight"}

    def lose_pod(self, pod: int) -> Dict[str, object]:
        """Platform-signaled loss of every worker on one pod."""
        killed = [(w.subspace, w.replica) for w in self.workers
                  if w.pod == pod and w.alive]
        rungs = [self._kill(s, rep)["rung"] for s, rep in killed]
        return {"pod": pod, "killed": killed,
                "rungs": [r for r in rungs if isinstance(r, str)],
                "dead_subspaces": self.dead_subspaces()}

    def revive_pod(self, pod: int) -> List[Tuple[int, int]]:
        """Bring a pod's workers back (re-grow after a correlated hit)."""
        revived = []
        for w in self.workers:
            if w.pod == pod and not w.alive:
                w.alive = True
                revived.append((w.subspace, w.replica))
        if revived:
            self._weights = self._partition_of_unity()
            self.p = None
        return revived

    # ---------------------------------------------------------------- faults

    def inject_correction_sdc(self, subspace: int, replica: int,
                              index: int, delta: float) -> None:
        """Queue an SDC into one replica's local correction next iterate."""
        self._pending_sdc.append((subspace, replica, index, delta))

    def corrupt_iterate(self, index: int, bit: int = 62) -> float:
        """DRAM-style bit flip in the resident iterate, in place on the
        device through its int64 view (bit 63's mask is -2^63, since
        1 << 63 does not fit an int64)."""
        bit %= 64
        mask = -(1 << 63) if bit == 63 else 1 << bit
        i = index % self.cfg.n
        self.x.view(torch.int64)[i] ^= mask
        return float(self.x[i])

    # ---------------------------------------------------------------- solve

    def _local_corrections(self) -> Dict[int, torch.Tensor]:
        """One verified correction per alive subspace, replica-redundant."""
        cands: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        for i in self.alive_subspaces():
            r_i = self.r[self.blocks[i]]
            for w in self.alive_workers(i):
                c = self.block_inv[i] @ r_i
                cands.setdefault(i, []).append((w.replica, c))
        for s, rep, idx, delta in self._pending_sdc:
            for j, (r_j, c) in enumerate(cands.get(s, [])):
                if r_j == rep:
                    c = c.clone()
                    c[idx % c.numel()] += delta
                    cands[s][j] = (r_j, c)
        self._pending_sdc = []
        for s, rep in self._pending_kills:
            # Mid-iteration loss: drop the worker's correction from THIS
            # sum; topology/weights update and the iteration continues.
            if s in cands:
                cands[s] = [(r_j, c) for r_j, c in cands[s] if r_j != rep]
                if not cands[s]:
                    del cands[s]
            self._kill(s, rep)
        self._pending_kills = []
        out: Dict[int, torch.Tensor] = {}
        for i, reps in cands.items():
            r_i = self.r[self.blocks[i]]
            scale = float(r_i.abs().max()) + 1e-30
            chosen = None
            for j, (rep, c) in enumerate(reps):
                resid = _finite_or_inf(float(
                    (self.block_a[i] @ c - r_i).abs().max()))
                if resid <= self.cfg.local_tol * scale + 1e-30:
                    chosen = c
                    if j > 0:
                        self.trips.append(GuardTrip(
                            self.iteration, "replica_repair",
                            f"subspace {i}: replica {reps[0][0]} failed "
                            f"local residual check, repaired from "
                            f"replica {rep}", resid, resid))
                    break
            if chosen is None:
                # Every replica corrupt (or lone survivor corrupt):
                # recompute the block solve from the resident block data.
                chosen = self.block_inv[i] @ r_i
                self.trips.append(GuardTrip(
                    self.iteration, "local_recompute",
                    f"subspace {i}: no replica passed the local residual "
                    f"check; recomputed", math.inf, 0.0))
            out[i] = chosen
        return out

    def _apply_preconditioner(self) -> torch.Tensor:
        z = torch.zeros(self.cfg.n, dtype=_F64, device=self.device)
        # one index_add_ per subspace, in subspace order: the sums land in
        # a fixed order, as np.add.at's do
        for i, c in self._local_corrections().items():
            w = self._weights[i]
            if w is None:    # died mid-iteration: weights were rebuilt
                w = 1.0 / torch.clamp(self.coverage()[self.blocks[i]],
                                      min=1.0)
            z.index_add_(0, self.blocks[i], w * c)
        return z

    def _explicit_rnorm(self, x: torch.Tensor) -> float:
        return _finite_or_inf(float(torch.linalg.norm(self.b - self.a @ x)))

    def _sanitize(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        bad = ~torch.isfinite(x) | (x.abs() > _SANITIZE_CLAMP)
        n_bad = int(bad.sum())
        if n_bad:
            x = torch.where(bad, torch.zeros((), dtype=_F64,
                                             device=x.device), x)
        return x, n_bad

    def _restart(self) -> int:
        """Sanitize + recompute + restart the direction; returns how many
        iterate entries the sanitizer had to zero (0 on a clean restart)."""
        self.x, n_bad = self._sanitize(self.x)
        self.r = self.b - self.a @ self.x
        self.z = self._apply_preconditioner()
        self.p = self.z.clone()
        self.rz = float(self.r @ self.z)
        self.rn_explicit = self._explicit_rnorm(self.x)
        return n_bad

    def iterate(self) -> float:
        """One guarded FCG iteration; returns the explicit residual norm."""
        cfg = self.cfg
        if self.p is None:
            # A topology change (subspace death / revive) forced a
            # direction restart: its sanitizer pass doubles as a detector
            # for corruption that lands in the same window — zeroed
            # entries are a real catch, not a silent fix.
            n_bad = self._restart()
            if n_bad:
                self.trips.append(GuardTrip(
                    self.iteration, "guard_restart",
                    f"direction restart sanitized {n_bad} corrupt "
                    f"iterate entr{'y' if n_bad == 1 else 'ies'}",
                    math.inf, self.rn_explicit))
        q = self.a @ self.p
        pq = float(self.p @ q)
        alpha = self.rz / pq if pq > 0 else 0.0
        x_cand = self.x + alpha * self.p
        r_cand = self.r - alpha * q
        rn_cand = self._explicit_rnorm(x_cand)
        floor = cfg.rtol * self.bnorm
        if rn_cand > cfg.guard_factor * max(self.rn_explicit, floor):
            # Monotonicity guard: the candidate is discarded (it was never
            # committed — this is within-iteration repair, not rollback),
            # the resident iterate is sanitized, and the solve restarts
            # its direction from a freshly recomputed residual.
            before = rn_cand
            self._restart()
            self.trips.append(GuardTrip(
                self.iteration, "guard_restart",
                f"explicit residual grew {before:.3e} -> guard tripped "
                f"(baseline {self.rn_explicit:.3e})",
                before, self.rn_explicit))
            self.iteration += 1
            return self.rn_explicit
        r_prev = self.r
        self.x, self.r, self.rn_explicit = x_cand, r_cand, rn_cand
        self.z = self._apply_preconditioner()
        if self.p is None:
            # A subspace died inside that preconditioner application and
            # the weights were renormalized: FCG restart on the new M.
            self.p = self.z.clone()
            self.rz = float(self.r @ self.z)
        else:
            # Flexible (Polak-Ribiere) beta: robust to the preconditioner
            # being re-weighted between iterations.
            beta = (float(self.z @ (self.r - r_prev)) / self.rz
                    if self.rz else 0.0)
            self.rz = float(self.r @ self.z)
            self.p = self.z + max(beta, 0.0) * self.p
        self.iteration += 1
        return self.rn_explicit

    @property
    def converged(self) -> bool:
        return self.rn_explicit <= self.cfg.rtol * self.bnorm

    def run(self, max_iters: Optional[int] = None,
            on_iteration: Optional[Callable[["RedundantSubspaceCG"], None]]
            = None) -> SolveReport:
        """Drive to convergence.  ``on_iteration(solver)`` fires before
        each iteration (iteration index in ``solver.iteration``) — the
        campaign injects faults and kills topology through it."""
        limit = self.cfg.max_iters if max_iters is None else max_iters
        while not self.converged and self.iteration < limit:
            if on_iteration is not None:
                on_iteration(self)
            self.iterate()
        return self.report()

    def report(self) -> SolveReport:
        return SolveReport(
            converged=self.converged,
            iterations=self.iteration,
            residual_norm=self.rn_explicit,
            rtol=self.cfg.rtol,
            trips=tuple(self.trips),
            failovers=tuple(self.failovers),
            reweights=tuple(self.reweights),
            dead_subspaces=tuple(self.dead_subspaces()),
        )

    def error_vs(self, other: "RedundantSubspaceCG") -> float:
        return float((self.x - other.x).abs().max())

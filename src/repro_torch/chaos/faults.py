"""Protection-surface registry of the PyTorch port.

A protection domain registers a `Surface` at import time describing what
it protects, what detects a fault there, and what end-state promise a
successful recovery makes (``bit_identity`` vs ``tolerance``).  Surfaces
with ``protected=False`` form the honest *uncovered ledger*: a surface
whose protection the port has not brought up yet is registered
unprotected, with a note naming what it waits for.

This is the registry part of the reference package's
``repro/chaos/faults.py`` plus its shard-erasure injection
(``FailurePlan``, ``FailureInjector``); the fault taxonomy and the SDC
injectors come with later slices.  It imports no other module of the port
but ``repro_torch.tree``, so every protection-domain module can import it
at module scope without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = [
    "Surface", "register_surface", "get_surface", "surfaces",
    "uncovered_surfaces", "ensure_registered", "FailurePlan",
    "FailureInjector",
]


# ---------------------------------------------------------------------------
# protection-surface registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Surface:
    """One protection domain (or honestly-unprotected surface).

    ``promise`` is the end-state contract a successful recovery makes and
    the campaign's comparison mode against the golden run:
    ``bit_identity`` (outputs must match bit for bit), ``tolerance``
    (float-solve repair: near-exact, compared within a tolerance), or
    ``none`` (no protection — nothing is promised).  ``kinds`` lists the
    fault kinds this surface's protection actually covers; a fault of any
    other kind landing here is *outside the envelope* and must show up as
    ``missed`` in the coverage matrix, not be silently skipped.
    """
    name: str               # e.g. "dist.collectives/abft_psum"
    owner: str              # module that registered it
    protected: bool
    promise: str = "none"   # "bit_identity" | "tolerance" | "none"
    detector: str = ""      # what sees a fault here (empty = nothing does)
    kinds: Tuple[str, ...] = ()
    note: str = ""

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


_REGISTRY: Dict[str, Surface] = {}

_PROMISES = ("bit_identity", "tolerance", "none")


def register_surface(name: str, *, owner: str, protected: bool,
                     promise: str = "none", detector: str = "",
                     kinds: Sequence[str] = (), note: str = "") -> Surface:
    """Register (idempotently) a protection domain / uncovered surface.

    Double registration is NOT last-write-wins: a ``protected=True``
    registration always wins over an unprotected placeholder regardless of
    which imported first (a module adding protection upgrades the ledger
    entry; a stale placeholder imported later can never silently erase
    it), and a conflicting re-registration at the SAME protection level by
    a DIFFERENT owner raises — two modules claiming one surface is a wiring
    bug, not a tie to break silently.  A module re-registering its own
    surface (reload) replaces it.
    """
    if promise not in _PROMISES:
        raise ValueError(f"unknown promise {promise!r}: expected one of "
                         f"{_PROMISES}")
    if protected and not detector:
        raise ValueError(f"protected surface {name!r} must name its "
                         "detector")
    s = Surface(name=name, owner=owner, protected=protected, promise=promise,
                detector=detector, kinds=tuple(kinds), note=note)
    old = _REGISTRY.get(name)
    if old is not None and old != s:
        if old.protected and not s.protected:
            # downgrade attempt: the placeholder loses, protection stays
            return old
        if not (s.protected and not old.protected) and old.owner != s.owner:
            raise ValueError(
                f"surface {name!r} already registered by {old.owner!r} "
                f"(protected={old.protected}); conflicting re-registration "
                f"by {s.owner!r} — two owners claiming one surface is a "
                "wiring bug")
    _REGISTRY[name] = s
    return s


def get_surface(name: str) -> Surface:
    if name not in _REGISTRY:
        ensure_registered()
    return _REGISTRY[name]


def surfaces() -> Dict[str, Surface]:
    """A copy of the current registry (call `ensure_registered` first for
    the full picture)."""
    return dict(_REGISTRY)


def uncovered_surfaces() -> List[Surface]:
    """The honest ledger: every registered surface with no protection.

    Self-registering (like `get_surface`): the owning modules are imported
    first, so a report generated before any workload path ran still sees
    the complete ledger instead of a stale subset."""
    ensure_registered()
    return sorted((s for s in _REGISTRY.values() if not s.protected),
                  key=lambda s: s.name)


def ensure_registered() -> Dict[str, Surface]:
    """Import every module that registers a surface, then return the
    registry.  Registration happens at import time in the owning module;
    campaigns and reports call this so the ledger is complete even when a
    workload path was never touched.  A module that starts registering (or
    upgrading) a surface MUST be added to this list, or reports generated
    before it imports will show a stale registry."""
    import importlib
    for mod in ("repro_torch.kernels.ops", "repro_torch.serve.engine",
                "repro_torch.models.layers", "repro_torch.ckpt.diskless"):
        importlib.import_module(mod)
    return dict(_REGISTRY)


# state sitting in device memory between steps: the in-step checksums are
# computed from inputs at call time, so a pre-corrupted value checksums
# consistently (garbage in, checksummed garbage out).  The port has no
# at-rest scrubber yet, so both surfaces stay on the uncovered ledger.
register_surface(
    "state.params_at_rest", owner="repro_torch.chaos.faults",
    protected=False,
    note="resident params between steps; the at-rest scrub comes with the "
         "serving-FT and elastic slices")
register_surface(
    "state.opt_state_at_rest", owner="repro_torch.chaos.faults",
    protected=False,
    note="optimizer moments between steps; the at-rest scrub comes with "
         "the elastic slice")


# ---------------------------------------------------------------------------
# shard-erasure injection — the paper's §4.3 "process killer"
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Deterministic plan: at step s, lose DP shard i (the paper's fixed
    EXIT-point mode).  Exact-duplicate events are dropped at construction,
    since the injector delivers each event once."""
    events: Tuple[Tuple[int, int], ...]   # (step, shard_index)

    def __post_init__(self):
        seen, out = set(), []
        for e in self.events:
            if e not in seen:
                seen.add(e)
                out.append(e)
        object.__setattr__(self, "events", tuple(out))

    @classmethod
    def random(cls, n_events: int, max_step: int, p: int, seed: int = 0):
        """The stress-test mode: random in time and location (§4.3), drawn
        exactly as the reference draws them (steps without replacement, at
        most one loss per step; ``n_events`` clamped to the drillable
        steps)."""
        rng = np.random.RandomState(seed)
        n_events = min(n_events, max_step - 1)
        steps = rng.choice(np.arange(1, max_step), size=n_events,
                           replace=False)
        ev = tuple(sorted(
            (int(s), int(rng.randint(0, p))) for s in steps))
        return cls(ev)


class FailureInjector:
    """Drives a `FailurePlan` through a training loop: `check(step)` fires
    each planned event once and returns the lost DP shard's index, and
    `damage(state, shard, leading)` applies the consequence: the shard's
    slice of every ``[p, ...]``-stacked floating leaf is NaN-poisoned, which
    a recovery path must repair without reading it."""

    def __init__(self, plan: FailurePlan):
        self.plan = plan
        self._fired: List[Tuple[int, int]] = []

    def check(self, step: int) -> Optional[int]:
        """The failed shard index if a failure fires at `step`, else None."""
        for (s, i) in self.plan.events:
            if s == step and (s, i) not in self._fired:
                self._fired.append((s, i))
                return i
        return None

    @staticmethod
    def damage(state, shard: int, leading: int):
        """NaN-poison shard `shard` of every [p, ...] stacked floating leaf.
        Returns a new tree; a poisoned leaf is a copy, the others are the
        input's own tensors."""
        def hit(x):
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[0] == leading and x.is_floating_point():
                x = x.clone()
                x[shard] = float("nan")
            return x
        return tree_map(hit, state)

"""Protection-surface registry of the PyTorch port.

A protection domain registers a `Surface` at import time describing what
it protects, what detects a fault there, and what end-state promise a
successful recovery makes (``bit_identity`` vs ``tolerance``).  Surfaces
with ``protected=False`` form the honest *uncovered ledger*: a surface
whose protection the port has not brought up yet is registered
unprotected, with a note naming what it waits for.

This is the registry part of the reference package's
``repro/chaos/faults.py``; the fault taxonomy and the injectors come with
the chaos slice.  Stdlib only, so every protection-domain module can
import it at module scope without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "Surface", "register_surface", "get_surface", "surfaces",
    "uncovered_surfaces", "ensure_registered",
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
                "repro_torch.models.layers"):
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
    note="optimizer moments between steps; training comes with the "
         "protected-LM slice")

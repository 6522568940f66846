"""Fault taxonomy, protection-surface registry and injectors of the
PyTorch port: the counterpart of the reference package's
``repro/chaos/faults.py``.

  1. **The surface registry.**  A protection domain registers a `Surface`
     at import time describing what it protects, what detects a fault
     there, and what end-state promise a successful recovery makes
     (``bit_identity`` vs ``tolerance``).  Surfaces with
     ``protected=False`` form the honest *uncovered ledger*: a surface
     whose protection the port has not brought up yet is registered
     unprotected, with a note naming what it waits for.
  2. **The `FaultSpec` taxonomy**: one declarative record per injectable
     fault (kind, target surface, workload, deterministic seed), and the
     `Episode`s and `FaultSpace`s built from them, name for name and field
     for field those of the reference, so a campaign artifact of either
     package replays in the other.
  3. **The injectors**: `FailurePlan`/`FailureInjector` (shard erasure),
     `SDCPlan`/`SDCInjector` (silent data corruption in a protected
     reduction, with `scatter_delta`, the caller-side shard selection) and
     `flip_bit`, the literal bit-flip fault model on a tensor.

It imports no other module of the port but ``repro_torch.tree``, so every
protection-domain module can import it at module scope without cycles.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = [
    "KINDS", "WORKLOADS", "RATE_KINDS", "Surface", "register_surface",
    "get_surface", "surfaces", "uncovered_surfaces", "ensure_registered",
    "kind_surface", "FaultSpec", "Episode", "FaultSpace",
    "FailurePlan", "FailureInjector", "SDCPlan", "SDCInjector",
    "flip_bit", "scatter_delta",
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
    for mod in ("repro_torch.kernels.ops",
                "repro_torch.kernels.flash_attention",
                "repro_torch.serve.engine", "repro_torch.models.layers",
                "repro_torch.ckpt.diskless", "repro_torch.dist.collectives",
                "repro_torch.ft.runtime"):
        importlib.import_module(mod)
    return dict(_REGISTRY)


# state sitting in device memory between steps: the in-step checksums are
# computed from inputs at call time, so a pre-corrupted value checksums
# consistently (garbage in, checksummed garbage out).  These placeholders
# are upgraded to protected by `ft.runtime`'s at-rest scrub on import.
register_surface(
    "state.params_at_rest", owner="repro_torch.chaos.faults",
    protected=False,
    note="resident params between steps; ft.runtime registers the at-rest "
         "scrub that protects them")
register_surface(
    "state.opt_state_at_rest", owner="repro_torch.chaos.faults",
    protected=False,
    note="optimizer moments between steps; ft.runtime registers the "
         "at-rest scrub that protects them")

# protection domains whose owning modules the port has not brought up yet.
# A fault spec aimed at one of them is reported as a ``skipped`` campaign
# row, and the row needs the surface; the owning module registers it
# protected when its slice lands (a protected registration wins).
for _name, _kinds, _slice in (
        ("ft.runtime/topology", ("pod_loss", "slow_pod"),
         "port slice 13 (multi-process distribution and ElasticRuntime's "
         "pod paths)"),
        ("serve.paged_kv/pages", ("dram_kv_cache",),
         "port slice 9 (paged serving)"),
        ("solvers.subspace_cg/correction_sum", ("sdc_collective",),
         "port slice 10 (the subspace solver)"),
        ("solvers.subspace_cg/iterate_at_rest", ("dram_params",),
         "port slice 10 (the subspace solver)"),
        ("solvers.subspace_cg/subspaces", ("shard_loss", "pod_loss"),
         "port slice 10 (the subspace solver)")):
    register_surface(_name, owner="repro_torch.chaos.faults",
                     protected=False, kinds=_kinds,
                     note=f"not ported yet: comes with {_slice}")


# ---------------------------------------------------------------------------
# the FaultSpec taxonomy
# ---------------------------------------------------------------------------


KINDS = ("sdc_collective", "checksum_state_flip", "flash_state_flip",
         "norm_corruption", "gather_corruption", "dram_params",
         "dram_opt_state", "dram_kv_cache", "shard_loss", "pod_loss",
         "slow_pod")

WORKLOADS = ("train", "serve", "solver", "traffic")

# kind -> which workloads can drill it and which surface it targets
_KIND_INFO = {
    "sdc_collective": dict(
        workloads=("train", "serve", "solver", "traffic"),
        surface={"train": "dist.collectives/abft_psum",
                 "serve": "serve.engine/logits_reduce",
                 "traffic": "serve.engine/logits_reduce",
                 "solver": "solvers.subspace_cg/correction_sum"}),
    "checksum_state_flip": dict(
        workloads=("train",), surface="kernels.ops/acc_state"),
    "flash_state_flip": dict(
        workloads=("train",), surface="kernels.flash_attention"),
    "norm_corruption": dict(
        workloads=("train",), surface="models.layers/layernorm"),
    "gather_corruption": dict(
        workloads=("train",), surface="models.layers/embedding_gather"),
    "dram_params": dict(
        workloads=("train", "serve", "solver", "traffic"),
        surface={"train": "state.params_at_rest",
                 "serve": "state.params_at_rest",
                 "traffic": "state.params_at_rest",
                 "solver": "solvers.subspace_cg/iterate_at_rest"}),
    "dram_opt_state": dict(
        workloads=("train",), surface="state.opt_state_at_rest"),
    "dram_kv_cache": dict(
        workloads=("serve", "traffic"),
        surface={"serve": "serve.engine/kv_cache_at_rest",
                 "traffic": "serve.paged_kv/pages"}),
    "shard_loss": dict(
        workloads=("train", "solver"),
        surface={"train": "ckpt.diskless/shards",
                 "solver": "solvers.subspace_cg/subspaces"}),
    "pod_loss": dict(
        workloads=("train", "solver"),
        surface={"train": "ft.runtime/topology",
                 "solver": "solvers.subspace_cg/subspaces"}),
    "slow_pod": dict(
        workloads=("train",), surface="ft.runtime/topology"),
}

# The kinds a Poisson-rate schedule may draw, per workload (the
# reference's set: train rate episodes thread one single-device runtime,
# so pod-topology kinds drill at rate in the solver family only).
RATE_KINDS = {
    "train": ("sdc_collective", "dram_params", "dram_opt_state",
              "shard_loss"),
    "serve": ("sdc_collective", "dram_params", "dram_kv_cache"),
    "solver": ("sdc_collective", "dram_params", "shard_loss", "pod_loss"),
    "traffic": ("sdc_collective", "dram_params", "dram_kv_cache"),
}


def kind_surface(kind: str, workload: str) -> str:
    s = _KIND_INFO[kind]["surface"]
    return s[workload] if isinstance(s, dict) else s


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault: what corrupts, where, when, deterministically.

    ``surface`` defaults to the kind's canonical protection domain (see
    `kind_surface`); override it to aim the same fault mechanics at a
    different registered surface.  ``variant`` selects a sub-path where a
    domain has several recovery rungs or operand types (pod_loss:
    "diskless"/"disk"; kernel drills: "bf16"/"int8"; flash: "l").  All
    fields are plain data: a spec is JSON-round-trippable and hashable,
    and the seed makes sampled spaces reproducible.
    """
    kind: str
    workload: str            # "train" | "serve" | "solver" | "traffic"
    step: int = 2            # step / decode step / CG iteration it fires at
    shard: int = 0           # DP or model-axis shard (sdc, shard_loss)
    pod: int = 0             # pod index (pod_loss, slow_pod)
    page: int = -1           # KV page (traffic dram_kv_cache); -1 = any live
    delta: float = 1e4       # additive corruption magnitude (sdc drills)
    bit: int = 30            # bit index for flip_bit faults (30 = exponent)
    delay_s: float = 0.05    # injected per-step delay floor (slow_pod)
    variant: str = ""        # sub-path selector
    seed: int = 0
    surface: str = ""        # resolved from the kind when empty

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: expected "
                             f"one of {KINDS}")
        if self.workload not in _KIND_INFO[self.kind]["workloads"]:
            raise ValueError(
                f"kind {self.kind!r} is not drillable under workload "
                f"{self.workload!r} (supported: "
                f"{_KIND_INFO[self.kind]['workloads']})")
        if not self.surface:
            object.__setattr__(self, "surface",
                               kind_surface(self.kind, self.workload))

    @property
    def name(self) -> str:
        """Unique within any well-formed space: every field that deviates
        from its default contributes a suffix."""
        bits = [self.workload, self.kind, f"s{self.step}"]
        if self.shard:
            bits.append(f"sh{self.shard}")
        if self.pod:
            bits.append(f"p{self.pod}")
        if self.page != -1:
            bits.append(f"pg{self.page}")
        if self.delta != 1e4:
            bits.append(f"d{self.delta:g}")
        if self.bit != 30:
            bits.append(f"b{self.bit}")
        if self.variant:
            bits.append(self.variant)
        if self.seed:
            bits.append(f"seed{self.seed}")
        return ":".join(bits)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        """Rebuild a spec from `asdict()` output (the replay path); unknown
        keys are ignored, validation is the constructor's."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def sdc_plan(self) -> "SDCPlan":
        """This spec as a one-event `SDCPlan`."""
        if self.kind != "sdc_collective":
            raise ValueError(f"{self.kind!r} is not an SDC-collective fault")
        return SDCPlan(((self.step, self.shard, self.delta),))

    def failure_plan(self) -> "FailurePlan":
        """This spec as the one-event `FailurePlan` driving shard loss."""
        if self.kind != "shard_loss":
            raise ValueError(f"{self.kind!r} is not a shard-loss fault")
        return FailurePlan(((self.step, self.shard),))


# Kinds whose target is a pod: `Episode.pod_affinity` re-aims these.
_POD_KINDS = ("pod_loss", "slow_pod")


@dataclasses.dataclass(frozen=True)
class Episode:
    """An ordered multi-fault scenario delivered into ONE live run:
    ``(step_offset, spec)`` events anchored at ``at_step``.
    ``pod_affinity`` re-aims every pod-targeting event at one pod (a
    correlated fault); ``rate_per_1k`` marks schedules drawn by
    `FaultSpace.poisson`."""
    name: str
    workload: str                               # "train"|"serve"|"solver"
    events: Tuple[Tuple[int, FaultSpec], ...]   # (step_offset, spec)
    at_step: int = 2
    pod_affinity: Optional[int] = None
    rate_per_1k: Optional[float] = None
    seed: int = 0
    note: str = ""

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}")
        events = tuple(sorted(((int(o), s) for o, s in self.events),
                              key=lambda e: e[0]))
        if not events:
            raise ValueError(f"episode {self.name!r} has no events")
        for off, spec in events:
            if off < 0:
                raise ValueError(f"episode {self.name!r}: negative "
                                 f"offset {off}")
            if spec.workload != self.workload:
                raise ValueError(
                    f"episode {self.name!r} is a {self.workload!r} episode "
                    f"but event {spec.name!r} targets {spec.workload!r}")
        object.__setattr__(self, "events", events)

    def __len__(self) -> int:
        return len(self.events)

    def resolved(self) -> Tuple[FaultSpec, ...]:
        """The concrete specs this episode delivers: offsets anchored at
        ``at_step`` and pod-targeting events re-aimed by pod_affinity."""
        out = []
        for off, spec in self.events:
            repl = {"step": self.at_step + off}
            if self.pod_affinity is not None and spec.kind in _POD_KINDS:
                repl["pod"] = self.pod_affinity
            out.append(dataclasses.replace(spec, **repl))
        return tuple(out)

    def asdict(self) -> dict:
        return {
            "name": self.name, "workload": self.workload,
            "at_step": self.at_step, "pod_affinity": self.pod_affinity,
            "rate_per_1k": self.rate_per_1k, "seed": self.seed,
            "note": self.note,
            "events": [{"offset": off, "spec": spec.asdict()}
                       for off, spec in self.events],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Episode":
        """Rebuild from `asdict()` output (the `--replay` path)."""
        events = tuple((int(e["offset"]), FaultSpec.from_dict(e["spec"]))
                       for e in d["events"])
        return cls(name=d["name"], workload=d["workload"], events=events,
                   at_step=int(d.get("at_step", 2)),
                   pod_affinity=d.get("pod_affinity"),
                   rate_per_1k=d.get("rate_per_1k"),
                   seed=int(d.get("seed", 0)), note=d.get("note", ""))


@dataclasses.dataclass(frozen=True)
class FaultSpace:
    """A named, ordered set of `FaultSpec`s (and multi-fault `Episode`s):
    `default()` (the committed campaign), `smoke()` (the single-device
    subset), `traffic_smoke()`, `cartesian()`, `episodes_smoke()` /
    `episodes_default()`, `poisson()` / `poisson_sweep()` and `sample()`,
    each the reference's space spec for spec."""
    name: str
    specs: Tuple[FaultSpec, ...]
    episodes: Tuple[Episode, ...] = ()

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    @classmethod
    def smoke(cls) -> "FaultSpace":
        """Sixteen single-device fault classes across the train, serve and
        solver workloads."""
        return cls("smoke", (
            FaultSpec(kind="sdc_collective", workload="train", step=2,
                      shard=0, delta=1e4),
            FaultSpec(kind="checksum_state_flip", workload="train", step=1,
                      bit=30),
            # the same carried-state promises on narrower operand streams:
            # a bf16 state flip stays detect-only, an SDC in the int8
            # wire's carried int32 data is located and repaired bit-exactly
            FaultSpec(kind="checksum_state_flip", workload="train", step=1,
                      bit=30, variant="bf16", seed=1),
            FaultSpec(kind="sdc_collective", workload="train", step=1,
                      bit=20, variant="int8",
                      surface="kernels.ops/acc_state"),
            FaultSpec(kind="flash_state_flip", workload="train", step=1),
            FaultSpec(kind="norm_corruption", workload="train", step=2),
            FaultSpec(kind="gather_corruption", workload="train", step=2),
            FaultSpec(kind="dram_params", workload="train", step=2, bit=30),
            FaultSpec(kind="dram_opt_state", workload="train", step=2,
                      bit=29),
            FaultSpec(kind="shard_loss", workload="train", step=3, shard=0),
            FaultSpec(kind="sdc_collective", workload="serve", step=1,
                      shard=0, delta=1e4),
            FaultSpec(kind="dram_kv_cache", workload="serve", step=2,
                      bit=30),
            FaultSpec(kind="sdc_collective", workload="solver", step=4,
                      shard=3, delta=1e4),
            FaultSpec(kind="dram_params", workload="solver", step=12,
                      bit=30),
            FaultSpec(kind="shard_loss", workload="solver", step=6,
                      shard=4),
            FaultSpec(kind="pod_loss", workload="solver", step=5, pod=1,
                      variant="paired"),
        ))

    @classmethod
    def traffic_smoke(cls) -> "FaultSpace":
        """The paged-serving load drill: one open-loop trace replayed clean
        and under these faults."""
        return cls("traffic-smoke", (
            FaultSpec(kind="sdc_collective", workload="traffic", step=3,
                      shard=0, delta=1e4),
            FaultSpec(kind="sdc_collective", workload="traffic", step=7,
                      shard=0, delta=-3e4, seed=1),
            FaultSpec(kind="dram_kv_cache", workload="traffic", step=5,
                      bit=30),
            FaultSpec(kind="dram_kv_cache", workload="traffic", step=9,
                      page=1, bit=29),
            FaultSpec(kind="dram_params", workload="traffic", step=4,
                      bit=30),
        ))

    @classmethod
    def default(cls) -> "FaultSpace":
        """The full committed campaign: all eleven kinds, every workload
        but traffic, both pod-loss recovery rungs, and the episode set."""
        return cls("default", cls.smoke().specs + (
            FaultSpec(kind="sdc_collective", workload="train", step=4,
                      shard=0, delta=-3e4, seed=1),
            FaultSpec(kind="sdc_collective", workload="serve", step=3,
                      shard=1, delta=-3e4, seed=1),
            FaultSpec(kind="dram_params", workload="serve", step=0, bit=30),
            FaultSpec(kind="flash_state_flip", workload="train", step=2,
                      variant="l", seed=1),
            # remaining dtype cells of the kernel carried-state matrix
            FaultSpec(kind="checksum_state_flip", workload="train", step=2,
                      bit=29, variant="int8", seed=2),
            FaultSpec(kind="sdc_collective", workload="train", step=2,
                      bit=30, variant="bf16", seed=2,
                      surface="kernels.ops/acc_state"),
            FaultSpec(kind="sdc_collective", workload="train", step=2,
                      bit=28, seed=3, surface="kernels.ops/acc_state"),
            FaultSpec(kind="shard_loss", workload="train", step=3, shard=1,
                      seed=1),
            FaultSpec(kind="pod_loss", workload="train", step=3,
                      variant="diskless"),
            FaultSpec(kind="pod_loss", workload="train", step=3,
                      variant="disk", seed=1),
            FaultSpec(kind="slow_pod", workload="train", step=1,
                      delay_s=0.05),
            FaultSpec(kind="pod_loss", workload="solver", step=5, pod=2),
        ), episodes=cls.episodes_default().episodes)

    @classmethod
    def episodes_smoke(cls) -> "FaultSpace":
        """For each of the train, serve and solver workloads, one
        overlapping episode plus one seeded Poisson rate schedule."""
        train_overlap = Episode(
            "train:sdc+dram_burst", "train", at_step=2, events=(
                (0, FaultSpec(kind="sdc_collective", workload="train",
                              delta=1e4)),
                (0, FaultSpec(kind="dram_params", workload="train",
                              bit=30)),
                (0, FaultSpec(kind="dram_params", workload="train",
                              bit=30, seed=1)),
                (1, FaultSpec(kind="dram_opt_state", workload="train",
                              bit=29)),
            ),
            note="SDC mid-collective in the same window as a two-leaf "
                 "DRAM burst, opt-state flip one step later")
        serve_overlap = Episode(
            "serve:sdc+kv_dram", "serve", at_step=1, events=(
                (0, FaultSpec(kind="sdc_collective", workload="serve",
                              delta=1e4)),
                (0, FaultSpec(kind="dram_kv_cache", workload="serve",
                              bit=30)),
                (1, FaultSpec(kind="dram_params", workload="serve",
                              bit=30)),
            ),
            note="decode-step SDC overlapping a KV-cache flip, params "
                 "flip on the next decode step")
        solver_overlap = Episode(
            "solver:sdc_during_pod_loss", "solver", at_step=6, events=(
                (0, FaultSpec(kind="pod_loss", workload="solver", pod=1,
                              variant="paired")),
                (0, FaultSpec(kind="sdc_collective", workload="solver",
                              shard=2, delta=1e4)),
            ),
            note="the acceptance pair: a whole pod dies in the SAME "
                 "iteration an SDC lands in a surviving replica's "
                 "correction")
        return cls("episodes-smoke", (), episodes=(
            train_overlap, serve_overlap, solver_overlap,
            cls.poisson(250.0, steps=8, workload="train", seed=7),
            cls.poisson(250.0, steps=3, workload="serve", seed=11),
            cls.poisson(150.0, steps=12, workload="solver", seed=5),
        ))

    @classmethod
    def episodes_default(cls) -> "FaultSpace":
        """The smoke episodes, the pod-mesh train episodes, the solver
        correlated episode, and the Poisson rate sweeps."""
        pod_overlap = Episode(
            "train:dram+podloss", "train", at_step=3, events=(
                (0, FaultSpec(kind="dram_params", workload="train",
                              bit=30)),
                (0, FaultSpec(kind="pod_loss", workload="train",
                              variant="diskless")),
                (1, FaultSpec(kind="dram_params", workload="train",
                              bit=30, seed=1)),
            ),
            note="DRAM flip in the same window as a pod loss (the "
                 "rung-3 rollback absorbs it), second flip landing "
                 "right after the reshard")
        pod_repeat = Episode(
            "train:pod_repeat", "train", at_step=3, pod_affinity=1,
            events=(
                (0, FaultSpec(kind="pod_loss", workload="train",
                              variant="diskless")),
                (2, FaultSpec(kind="pod_loss", workload="train",
                              variant="diskless", seed=1)),
            ),
            note="correlated: the same physical pod dies again two "
                 "steps after being re-grown")
        solver_repeat = Episode(
            "solver:pod_repeat", "solver", at_step=4, pod_affinity=0,
            events=(
                (0, FaultSpec(kind="pod_loss", workload="solver",
                              variant="paired")),
                (4, FaultSpec(kind="pod_loss", workload="solver",
                              variant="paired", seed=1)),
            ),
            note="correlated: pod 0 dies, is revived, and dies again "
                 "four iterations later")
        smoke = cls.episodes_smoke().episodes
        return cls("episodes-default", (), episodes=smoke + (
            pod_overlap, pod_repeat, solver_repeat,
        ) + cls.poisson_sweep((125.0, 250.0, 500.0), steps=8,
                              workload="train", seed=3).episodes
          + cls.poisson_sweep((125.0, 250.0), steps=3,
                              workload="serve", seed=3).episodes
          + cls.poisson_sweep((50.0, 150.0, 400.0), steps=12,
                              workload="solver", seed=3).episodes)

    @classmethod
    def poisson(cls, events_per_1k_steps: float, *, steps: int = 8,
                workload: str = "train", seed: int = 0,
                name: str = "") -> "Episode":
        """A seeded Poisson fault schedule: per step, the event count is
        drawn from Poisson(rate/1000) and each event's kind uniformly from
        `RATE_KINDS[workload]`.  Deterministic in (rate, steps, workload,
        seed); an empty draw advances the seed to the first non-empty
        one."""
        if workload not in RATE_KINDS:
            raise ValueError(f"no rate kinds for workload {workload!r}")
        kinds = RATE_KINDS[workload]
        for attempt in range(seed, seed + 64):
            rng = np.random.RandomState(attempt)
            events = []
            for t in range(steps):
                for _ in range(int(rng.poisson(events_per_1k_steps / 1e3))):
                    kind = kinds[int(rng.randint(0, len(kinds)))]
                    fields = dict(kind=kind, workload=workload,
                                  seed=len(events))
                    if kind == "pod_loss":
                        fields["pod"] = int(rng.randint(0, 3))
                        if workload == "solver":
                            fields["variant"] = "paired"
                    elif kind == "shard_loss":
                        fields["shard"] = int(rng.randint(0, 12)) \
                            if workload == "solver" else 0
                    events.append((t, FaultSpec(**fields)))
            if events:
                return Episode(
                    name or f"{workload}:poisson{events_per_1k_steps:g}",
                    workload, tuple(events), at_step=1,
                    rate_per_1k=events_per_1k_steps, seed=attempt,
                    note=f"Poisson schedule, {events_per_1k_steps:g} "
                         f"events/1k steps over {steps} steps")
        raise ValueError(
            f"no non-empty Poisson draw at rate {events_per_1k_steps}")

    @classmethod
    def poisson_sweep(cls, rates: Sequence[float], *, steps: int = 8,
                      workload: str = "train", seed: int = 0) -> "FaultSpace":
        """One Poisson episode per rate."""
        eps = tuple(cls.poisson(r, steps=steps, workload=workload,
                                seed=seed + i) for i, r in enumerate(rates))
        return cls(f"poisson-{workload}", (), episodes=eps)

    @classmethod
    def cartesian(cls, *, name: str = "cartesian",
                  kinds: Sequence[str] = KINDS,
                  workloads: Sequence[str] = ("train", "serve"),
                  steps: Sequence[int] = (2,),
                  shards: Sequence[int] = (0,),
                  deltas: Sequence[float] = (1e4,),
                  bits: Sequence[int] = (30,)) -> "FaultSpace":
        """The explicit product over the knobs, kind-validity filtered."""
        specs = []
        for k, w, s, sh, d, b in itertools.product(kinds, workloads, steps,
                                                   shards, deltas, bits):
            if w not in _KIND_INFO[k]["workloads"]:
                continue
            specs.append(FaultSpec(kind=k, workload=w, step=s, shard=sh,
                                   delta=d, bit=b))
        return cls(name, tuple(specs))

    def sample(self, n: int, seed: int = 0) -> "FaultSpace":
        """A seeded without-replacement subsample of the one-fault specs
        (order-preserving; episodes ride along unsampled)."""
        if n >= len(self.specs):
            return self
        rng = np.random.RandomState(seed)
        idx = sorted(rng.choice(len(self.specs), size=n, replace=False))
        return FaultSpace(f"{self.name}-sample{n}-seed{seed}",
                          tuple(self.specs[i] for i in idx),
                          episodes=self.episodes)


# ---------------------------------------------------------------------------
# the bit-flip fault model
# ---------------------------------------------------------------------------


def flip_bit(x: torch.Tensor, flat_index: int, bit: int = 30) -> torch.Tensor:
    """XOR one bit of a float32/int32 tensor element (the literal fault
    model); returns a new tensor, ``x`` is untouched.  On fp32, bit 30 is
    the top exponent bit, ~23-29 exponent, <23 mantissa; on int32 bit b is
    an additive +-2^b.  Works through an int32 view; bit 31's mask is
    -2^31, since 1 << 31 does not fit an int32."""
    if x.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"bit-flip model is defined on 32-bit words "
                        f"(float32 or int32), got {x.dtype}")
    if not 0 <= bit <= 31:
        raise ValueError(f"bit {bit} outside a 32-bit word")
    out = x.clone()
    words = out.view(torch.int32).view(-1)
    mask = -2 ** 31 if bit == 31 else 1 << bit
    words[flat_index] ^= mask
    return out


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


def scatter_delta(extent: int, shard, delta,
                  device=None) -> torch.Tensor:
    """``[extent]`` fp32 vector carrying `delta` at index `shard`, zero
    elsewhere: the caller-side shard selection of a drill, handed to
    `dist.collectives.abft_psum` as ``inject_local``.  An out-of-range
    `shard` raises (the reference's scatter would drop it silently)."""
    out = torch.zeros((extent,), dtype=torch.float32, device=device)
    out[int(shard)] += float(delta)
    return out


# ---------------------------------------------------------------------------
# Silent data corruption (SDC): the paper's bit-flip fault model.  Unlike a
# shard loss (erasure), an SDC leaves no platform signal: only the ABFT
# checksums (core.abft_gemm in the matmuls, dist.collectives.abft_psum in
# the reductions) can see it.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SDCPlan:
    """Deterministic SDC schedule: at step s, shard i's contribution to a
    protected reduction is corrupted by `delta`.  A step may carry several
    events; exact duplicates are dropped at construction."""
    events: Tuple[Tuple[int, int, float], ...]   # (step, dp_shard, delta)

    def __post_init__(self):
        seen, out = set(), []
        for e in self.events:
            if e not in seen:
                seen.add(e)
                out.append(e)
        object.__setattr__(self, "events", tuple(out))

    def events_at(self, step: int) -> Tuple[Tuple[int, float], ...]:
        """All (shard, delta) payloads planned for `step`, in plan order."""
        return tuple((i, d) for (s, i, d) in self.events if s == step)

    @classmethod
    def random(cls, n_events: int, max_step: int, p: int, seed: int = 0,
               magnitude: float = 1e3):
        """Random in time and location (§4.3 stress mode), at most one
        event per step, drawn exactly as the reference draws them."""
        rng = np.random.RandomState(seed)
        n_events = min(n_events, max_step - 1)
        steps = rng.choice(np.arange(1, max_step), size=n_events,
                           replace=False)
        ev = tuple(sorted(
            (int(s), int(rng.randint(0, p)),
             float(magnitude * rng.choice([-1.0, 1.0])))
            for s in steps))
        return cls(ev)


class SDCInjector:
    """Drives an `SDCPlan`: `check(step)` fires each planned event once,
    returning ``(shard, delta)`` for the consumer to thread into a
    checksum-protected reduction (`train.step` through
    ``StepOptions.sdc_inject``, `serve.engine` through its drilled decode).
    The injection lands after the contribution's checksums are taken, so
    only the checksums riding the reduction can see it."""

    def __init__(self, plan: SDCPlan):
        self.plan = plan
        self._fired: List[Tuple[int, int, float]] = []

    def _fire(self, step: int):
        """Yield each unfired event planned for `step`, marking it fired as
        it is taken."""
        for (s, i, d) in self.plan.events:
            if s == step and (s, i, d) not in self._fired:
                self._fired.append((s, i, d))
                yield i, d

    def check(self, step: int) -> Optional[Tuple[int, float]]:
        """``(shard, delta)`` if an SDC event fires at `step`, else None;
        one event per call (several same-step events come out one call at
        a time)."""
        return next(self._fire(step), None)

    def check_all(self, step: int) -> Tuple[Tuple[int, float], ...]:
        """Fire and return every unfired event planned for `step`: each
        payload lands in a different protected reduction of one step
        (`dist.collectives.abft_psum_tree(inject=...)`)."""
        return tuple(self._fire(step))

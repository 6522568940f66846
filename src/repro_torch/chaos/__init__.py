"""repro_torch.chaos — declarative fault campaigns over the port's
protection domains.

  * `chaos.faults`   — the `FaultSpec` taxonomy and the protection-surface
    registry (domains register themselves; unprotected surfaces are an
    honest ledger), plus the injectors (`FailurePlan`/`FailureInjector`,
    `SDCPlan`) and the `flip_bit` fault model.
  * `chaos.campaign` — `CampaignRunner` sweeps a `FaultSpace` over the
    drills the port has brought up and classifies every event.
  * `chaos.report`   — the coverage-matrix artifact (JSON + markdown)
    with the uncovered-surface ledger.

`chaos.faults` is light (numpy and torch only) so protection-domain
modules can register their surfaces at import time; the campaign module
loads lazily to keep that edge acyclic.
"""
from repro_torch.chaos.faults import (FailureInjector, FailurePlan,
                                      FaultSpace, FaultSpec, SDCPlan,
                                      Surface, ensure_registered,
                                      flip_bit, get_surface,
                                      register_surface, surfaces,
                                      uncovered_surfaces)

__all__ = [
    "CampaignRunner", "CampaignResult", "FailureInjector", "FailurePlan",
    "FaultSpace", "FaultSpec", "SDCPlan", "Surface",
    "ensure_registered", "flip_bit", "get_surface", "register_surface",
    "surfaces", "uncovered_surfaces",
]

_LAZY = {"CampaignRunner": "repro_torch.chaos.campaign",
         "CampaignResult": "repro_torch.chaos.campaign"}


def __getattr__(name):
    # campaign imports kernels.ops and models.layers, which import
    # chaos.faults: an eager import here would cycle
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

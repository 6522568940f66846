"""Failure injection: a shim over `repro_torch.chaos.faults`, as the
reference's ``repro/ft/failures.py`` is over ``repro.chaos.faults``."""
from __future__ import annotations

from repro_torch.chaos.faults import (FailureInjector, FailurePlan,
                                      SDCInjector, SDCPlan, flip_bit,
                                      scatter_delta)

__all__ = ["FailurePlan", "FailureInjector", "SDCPlan", "SDCInjector",
           "flip_bit", "scatter_delta"]

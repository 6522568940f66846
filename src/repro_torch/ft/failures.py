"""Failure injection: a shim over `repro_torch.chaos.faults`, as the
reference's ``repro/ft/failures.py`` is over ``repro.chaos.faults``.  The
SDC plans and injectors come with the elastic slice."""
from __future__ import annotations

from repro_torch.chaos.faults import FailureInjector, FailurePlan

__all__ = ["FailurePlan", "FailureInjector"]

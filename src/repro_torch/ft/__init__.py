"""Fault-tolerance layer: shard-failure injection plans and the recovery
runtime (diskless checksum solve first, disk restore as fallback)."""
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.ft.runtime import (FTPolicy, FTRuntime, stack_view,
                                    unstack_view)

__all__ = ["FailurePlan", "FailureInjector", "FTPolicy", "FTRuntime",
           "stack_view", "unstack_view"]

"""Fault-tolerance layer: shard-failure and SDC injection plans and the
recovery runtimes (in-step ABFT, diskless checksum solve first, disk
restore as fallback, the at-rest scrub)."""
from repro_torch.ft.failures import (FailureInjector, FailurePlan,
                                     SDCInjector, SDCPlan)
from repro_torch.ft.runtime import (ElasticRuntime, FTPolicy, FTRuntime,
                                    ScrubReport, stack_view, unstack_view)

__all__ = ["FailurePlan", "FailureInjector", "SDCPlan", "SDCInjector",
           "FTPolicy", "FTRuntime", "ElasticRuntime", "ScrubReport",
           "stack_view", "unstack_view"]

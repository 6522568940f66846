"""Fault-tolerance layer: shard-failure and SDC injection plans and the
recovery runtimes (in-step ABFT, diskless checksum solve first, disk
restore as fallback, the at-rest scrub, the elastic shrink and re-grow
of a pod)."""
from repro_torch.ft.failures import (FailureInjector, FailurePlan,
                                     SDCInjector, SDCPlan, flip_bit)
from repro_torch.ft.runtime import (ElasticReport, ElasticRuntime, FTPolicy,
                                    FTRuntime, MeshGeneration, ScrubReport,
                                    StragglerDetector, stack_view,
                                    unstack_view)

__all__ = ["FailurePlan", "FailureInjector", "SDCPlan", "SDCInjector",
           "flip_bit", "FTPolicy", "FTRuntime", "ElasticRuntime",
           "MeshGeneration", "ElasticReport", "StragglerDetector",
           "ScrubReport", "stack_view", "unstack_view"]

"""Checkpointing of the train state: diskless (checksums in memory, the
paper's §2.1), on disk, and the elastic re-placement onto another mesh."""
from repro_torch.ckpt import elastic
from repro_torch.ckpt.disk import CheckpointManager
from repro_torch.ckpt.diskless import DisklessCheckpoint
from repro_torch.ckpt.elastic import (ReshardPlan, plan_reshard,
                                      reshard_restore, reshard_state,
                                      survivor_mesh)

__all__ = ["CheckpointManager", "DisklessCheckpoint", "elastic",
           "ReshardPlan", "plan_reshard", "reshard_restore",
           "reshard_state", "survivor_mesh"]

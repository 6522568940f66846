"""Checkpointing of the train state: diskless (checksums in memory, the
paper's §2.1) and on disk."""
from repro_torch.ckpt.disk import CheckpointManager
from repro_torch.ckpt.diskless import DisklessCheckpoint

__all__ = ["CheckpointManager", "DisklessCheckpoint"]

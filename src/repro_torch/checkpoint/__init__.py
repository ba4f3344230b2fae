"""Atomic keep-k checkpoints in the reference package's on-disk layout."""

from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]

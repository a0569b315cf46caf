"""Checkpointing in the reference's file format (twin of
``repro.checkpoint``)."""
from .ckpt import (CheckpointError, latest_checkpoint, restore_checkpoint,
                   restore_latest, save_checkpoint)

__all__ = ["CheckpointError", "save_checkpoint", "restore_checkpoint",
           "restore_latest", "latest_checkpoint"]

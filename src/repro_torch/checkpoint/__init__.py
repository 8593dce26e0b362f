"""Checkpoints in the reference's on-disk format (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    Checkpointer, save_checkpoint, restore_checkpoint, latest_step,
    committed_steps, gc_incomplete, tree_paths,
)

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step", "committed_steps", "gc_incomplete", "tree_paths"]

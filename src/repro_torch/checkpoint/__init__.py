"""Checkpoints in the reference's on-disk layout (``checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               CheckpointWriteError,
                                               latest_step, list_steps,
                                               manifest_extra, restore, save)

__all__ = ["AsyncCheckpointer", "CheckpointWriteError", "latest_step",
           "list_steps", "manifest_extra", "restore", "save"]

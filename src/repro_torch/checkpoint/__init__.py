"""Checkpoint substrate of the port (the reference's ``checkpoint``
package, in its on-disk format)."""

from .store import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

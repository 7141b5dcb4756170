"""Checkpointing substrate."""

from .store import (CheckpointManager, load_checkpoint,  # noqa: F401
                    save_checkpoint)

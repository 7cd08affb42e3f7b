"""Step-tagged, atomic, torn-write-detecting checkpoints (the
reference's on-disk format)."""

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CorruptCheckpointError)

__all__ = ["CheckpointManager", "CorruptCheckpointError"]

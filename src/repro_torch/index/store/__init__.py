"""Label residency for `CHLIndex` (dense in this slice)."""

from repro_torch.index.store.base import (CorruptArtifactError, LabelStore,
                                          shard_filename)
from repro_torch.index.store.dense import DenseStore

__all__ = ["CorruptArtifactError", "DenseStore", "LabelStore",
           "shard_filename"]

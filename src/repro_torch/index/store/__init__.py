"""Label residency for `CHLIndex`: one dense table or K hub shards."""

from repro_torch.index.store.base import (LOAD_STORE_KINDS,
                                          CorruptArtifactError, LabelStore,
                                          shard_filename)
from repro_torch.index.store.dense import DenseStore
from repro_torch.index.store.sharded import ShardedStore

__all__ = ["CorruptArtifactError", "DenseStore", "LOAD_STORE_KINDS",
           "LabelStore", "ShardedStore", "shard_filename"]

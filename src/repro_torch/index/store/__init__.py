"""Label residency for `CHLIndex`: one dense table, K hub shards,
memory-mapped shard files or encoded (compressed) shards."""

from repro_torch.index.store.base import (LOAD_STORE_KINDS,
                                          CorruptArtifactError, LabelStore,
                                          shard_filename)
from repro_torch.index.store.compressed import CompressedStore
from repro_torch.index.store.dense import DenseStore
from repro_torch.index.store.sharded import ShardedStore
from repro_torch.index.store.spill import (SpillStore, open_npz_arrays,
                                           open_shard)

__all__ = ["CompressedStore", "CorruptArtifactError", "DenseStore",
           "LOAD_STORE_KINDS", "LabelStore", "ShardedStore", "SpillStore",
           "open_npz_arrays", "open_shard", "shard_filename"]

"""Hub partitioning of label stores (paper §5.1 hub ownership)."""

from repro_torch.parallel.sharding import (ShardAccumulator, hub_owner,
                                           hub_partition_arrays)

__all__ = ["ShardAccumulator", "hub_owner", "hub_partition_arrays"]

"""Hub partitioning of label stores (paper §5.1 hub ownership), the
node mesh of the distributed builds and its collectives."""

from repro_torch.parallel.collectives import all_gather, pmax, pmin
from repro_torch.parallel.mesh import NodeMesh, make_node_mesh
from repro_torch.parallel.sharding import (ShardAccumulator, hub_owner,
                                           hub_partition_arrays)

__all__ = ["NodeMesh", "ShardAccumulator", "all_gather", "hub_owner",
           "hub_partition_arrays", "make_node_mesh", "pmax", "pmin"]

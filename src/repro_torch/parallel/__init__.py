"""Logical-axis sharding of the LM zoo (rules, specs, placements on a
``DeviceMesh``), hub partitioning of label stores (paper §5.1 hub
ownership), the node mesh of the distributed builds and its
collectives."""

from repro_torch.parallel.collectives import all_gather, pmax, pmin
from repro_torch.parallel.logical import (axis_rules, constrain,
                                          current_rules, placements,
                                          spec_for)
from repro_torch.parallel.mesh import NodeMesh, make_node_mesh
from repro_torch.parallel.sharding import (FSDP_OPT_RULES, FSDP_RULES,
                                           SP_RULES, TP_RULES,
                                           ShardAccumulator,
                                           batch_sharding,
                                           head_dim_fallback, hub_owner,
                                           hub_partition_arrays,
                                           replicated, resolve_params)

__all__ = ["FSDP_OPT_RULES", "FSDP_RULES", "NodeMesh", "SP_RULES",
           "ShardAccumulator", "TP_RULES", "all_gather", "axis_rules",
           "batch_sharding", "constrain", "current_rules",
           "head_dim_fallback", "hub_owner", "hub_partition_arrays",
           "make_node_mesh", "placements", "pmax", "pmin", "replicated",
           "resolve_params", "spec_for"]

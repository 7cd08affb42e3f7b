"""The paper's own workload as a configuration: one distributed PLaNT
(and one DGLL) superstep per cluster node.

Per-cluster-node state is the hub-partitioned label table; ``q``, the
number of CHL nodes, is the size of the node mesh
(`repro_torch.parallel.mesh.NodeMesh`): every node runs its trees
independently (paper §5)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChlConfig:
    name: str
    n: int                  # vertices
    max_deg: int            # ELL width (degree-capped)
    batch: int              # trees per node per batch
    trees_per_node: int     # superstep size T
    cap: int                # per-node label capacity per vertex
    hc_cap: int             # common-label-table capacity
    compact: int = 4096     # §Perf-2 compact-broadcast budget per tree

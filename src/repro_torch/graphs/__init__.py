"""Graph substrate: capped-ELL + tail + CSR graphs, generators,
rankings."""

from repro_torch.graphs.generators import (grid_road, random_connected,
                                           random_geometric, scale_free)
from repro_torch.graphs.graph import (ELL_CAP, DeviceGraph, Graph, cap_ell,
                                      device_adjacency, device_arrays,
                                      from_edges, to_networkx)
from repro_torch.graphs.ranking import (betweenness_ranking, degree_ranking,
                                       random_ranking)

__all__ = ["DeviceGraph", "ELL_CAP", "Graph", "betweenness_ranking",
           "cap_ell", "degree_ranking", "device_adjacency", "device_arrays",
           "from_edges", "grid_road", "random_connected",
           "random_geometric", "random_ranking", "scale_free",
           "to_networkx"]

"""Graph substrate: padded-ELL + CSR graphs, generators, rankings."""

from repro_torch.graphs.generators import (grid_road, random_connected,
                                           scale_free)
from repro_torch.graphs.graph import (DeviceGraph, Graph, device_arrays,
                                      from_edges)
from repro_torch.graphs.ranking import (betweenness_ranking, degree_ranking,
                                       random_ranking)

__all__ = ["DeviceGraph", "Graph", "betweenness_ranking", "degree_ranking",
           "device_arrays", "from_edges", "grid_road", "random_connected",
           "random_ranking", "scale_free"]

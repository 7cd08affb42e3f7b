"""Numpy/heapq Dijkstra oracles (ground truth for rankings and tests)."""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

from repro_torch.graphs.graph import Graph


def dijkstra(g: Graph, root: int) -> np.ndarray:
    """Distances from ``root`` (float64, ``inf`` if unreachable)."""
    return dijkstra_tree(g, root)[0]


def dijkstra_tree(g: Graph, root: int) -> Tuple[np.ndarray, np.ndarray]:
    """Distances + a parent array (one shortest-path tree)."""
    dist = np.full(g.n, np.inf)
    parent = np.full(g.n, -1, dtype=np.int64)
    dist[root] = 0.0
    pq = [(0.0, root)]
    while pq:
        d, v = heapq.heappop(pq)
        if d > dist[v]:
            continue
        ids, w = g.out_edges(v)
        for u, wt in zip(ids.tolist(), w.tolist()):
            nd = d + wt
            if nd < dist[u]:
                dist[u] = nd
                parent[u] = v
                heapq.heappush(pq, (nd, u))
    return dist, parent

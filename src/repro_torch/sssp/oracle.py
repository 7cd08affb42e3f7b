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


def dijkstra_maxrank(g: Graph, root: int,
                     rank: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Distances + ``mrank[v]`` = max rank over the union of all
    shortest ``root -> v`` paths (endpoints inclusive): the scalar
    oracle of PLaNT's criterion, label ``(root, v)`` is canonical iff
    ``mrank[v] == rank[root]``. A digraph's predecessors are read from
    its reverse."""
    dist = dijkstra(g, root)
    gin = g.reverse() if g.directed else g   # predecessor enumeration
    mrank = np.full(g.n, -1, dtype=np.int64)
    mrank[root] = rank[root]
    for v in np.argsort(dist, kind="stable"):
        if not np.isfinite(dist[v]) or v == root:
            continue
        best = -1
        ids, w = gin.out_edges(v)        # the in-edges of v
        for u, wt in zip(ids.tolist(), w.tolist()):
            if np.isfinite(dist[u]) and dist[u] + wt == dist[v]:
                best = max(best, mrank[u])
        mrank[v] = max(best, int(rank[v]))
    return dist, mrank


def all_pairs(g: Graph) -> np.ndarray:
    """All-pairs distances (test scale only)."""
    return np.stack([dijkstra(g, v) for v in range(g.n)])

"""Network hierarchies (ranking functions R).

``rank[v]`` is an ``int32`` in ``[0, n)``; larger = more important.
Ranks are a total order, ties broken by vertex id.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph


def _order_to_rank(order_desc: np.ndarray, n: int) -> np.ndarray:
    """``order_desc[0]`` is the most important vertex -> rank ``n-1``."""
    rank = np.empty(n, dtype=np.int32)
    rank[order_desc] = np.arange(n - 1, -1, -1, dtype=np.int32)
    return rank


def degree_ranking(g: Graph) -> np.ndarray:
    """Degree hierarchy (the paper's choice for scale-free graphs)."""
    deg = np.diff(g.indptr).astype(np.int64)
    order = np.lexsort((np.arange(g.n), -deg))
    return _order_to_rank(order.astype(np.int64), g.n)


def betweenness_ranking(g: Graph, samples: int = 16,
                        seed: int = 0) -> np.ndarray:
    """Sampled-SPT approximate betweenness (the paper's choice for
    roads): over ``samples`` Dijkstra trees from random roots, count
    each vertex's tree descendants."""
    from repro_torch.sssp.oracle import dijkstra_tree

    rng = np.random.default_rng(seed)
    score = np.zeros(g.n, dtype=np.float64)
    roots = rng.choice(g.n, size=min(samples, g.n), replace=False)
    for r in roots:
        dist, parent = dijkstra_tree(g, int(r))
        order = np.argsort(dist)[::-1]
        acc = np.ones(g.n, dtype=np.float64)
        acc[~np.isfinite(dist)] = 0.0
        for v in order:
            p = parent[v]
            if p >= 0 and np.isfinite(dist[v]):
                acc[p] += acc[v]
        score += np.where(np.isfinite(dist), acc, 0.0)
    order = np.lexsort((np.arange(g.n), -score))
    return _order_to_rank(order.astype(np.int64), g.n)


def random_ranking(n: int, seed: int = 0) -> np.ndarray:
    """A uniformly random hierarchy (a permutation of ``[0, n)``)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n).astype(np.int32)

"""Sequential Pruned Landmark Labeling (Akiba et al.): the CHL oracle.

Host-side numpy/heapq implementation used as ground truth: for a given
hierarchy R, sequential PLL outputs exactly the Canonical Hub Labeling,
and every parallel algorithm is held to label-set equality with it.
A digraph gets the forward/backward pair (paper footnote 1):
``pll_directed`` returns ``(L_out, L_in)``, queried over
``L_out[u]`` and ``L_in[v]``.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.graphs.graph import Graph

LabelSets = List[Dict[int, float]]   # per-vertex {hub: dist}


def _query(lu: Dict[int, float], lv: Dict[int, float]) -> float:
    best = np.inf
    if len(lu) > len(lv):
        lu, lv = lv, lu
    for h, d in lu.items():
        dv = lv.get(h)
        if dv is not None and d + dv < best:
            best = d + dv
    return best


def pll_undirected(g: Graph, rank: np.ndarray) -> LabelSets:
    """One pruned Dijkstra per vertex in rank-descending order: a
    vertex whose distance the labels so far already answer is neither
    labelled nor expanded."""
    labels: LabelSets = [dict() for _ in range(g.n)]
    order = np.argsort(-np.asarray(rank).astype(np.int64), kind="stable")
    for h in order.tolist():
        lh = labels[h]
        dist = {h: 0.0}
        pq = [(0.0, h)]
        while pq:
            d, v = heapq.heappop(pq)
            if d > dist.get(v, np.inf):
                continue
            if _query(lh, labels[v]) <= d:
                continue                      # pruned: no label, no expand
            labels[v][h] = d
            ids, w = g.out_edges(v)
            for u, wt in zip(ids.tolist(), w.tolist()):
                nd = d + wt
                if nd < dist.get(u, np.inf):
                    dist[u] = nd
                    heapq.heappush(pq, (nd, u))
    return labels


def pll_directed(g: Graph, rank: np.ndarray
                 ) -> Tuple[LabelSets, LabelSets]:
    """``(L_out, L_in)``: per hub in rank-descending order, a pruned tree
    on G (``d(h->v)``, into ``L_in``) and one on its reverse
    (``d(v->h)``, into ``L_out``); query(u->v) is over
    ``L_out[u]`` and ``L_in[v]``."""
    gr = g.reverse()
    l_out: LabelSets = [dict() for _ in range(g.n)]
    l_in: LabelSets = [dict() for _ in range(g.n)]
    order = np.argsort(-np.asarray(rank).astype(np.int64), kind="stable")

    def tree(graph: Graph, h: int, own: LabelSets,
             own_h: Dict[int, float]) -> None:
        # visiting v at distance d is a path h->v in `graph`; it is
        # pruned when the hubs of own_h and own[v] already answer d
        dist = {h: 0.0}
        pq = [(0.0, h)]
        while pq:
            d, v = heapq.heappop(pq)
            if d > dist.get(v, np.inf):
                continue
            if _query(own_h, own[v]) <= d:
                continue
            own[v][h] = d
            ids, w = graph.out_edges(v)
            for u, wt in zip(ids.tolist(), w.tolist()):
                nd = d + wt
                if nd < dist.get(u, np.inf):
                    dist[u] = nd
                    heapq.heappush(pq, (nd, u))

    for h in order.tolist():
        # when h's trees run, L_out[h] and L_in[h] hold higher-ranked
        # hubs only
        tree(g, h, l_in, l_out[h])
        tree(gr, h, l_out, l_in[h])
    return l_out, l_in


def chl_by_definition(g: Graph, rank: np.ndarray) -> LabelSets:
    """CHL straight from the definition (O(n^2): tiny graphs only): for
    every connected pair (u, v), the max-rank vertex over the union of
    all shortest u-v paths is a hub of both."""
    from repro_torch.sssp.oracle import all_pairs

    if g.directed:
        raise ValueError("chl_by_definition needs an undirected graph")
    D = all_pairs(g)
    labels: LabelSets = [dict() for _ in range(g.n)]
    for u in range(g.n):
        for v in range(u, g.n):
            if not np.isfinite(D[u, v]):
                continue
            on_path = np.isfinite(D[u]) & np.isfinite(D[v]) & (
                D[u] + D[v] == D[u, v])
            cand = np.nonzero(on_path)[0]
            hm = cand[np.argmax(rank[cand])]
            labels[u][int(hm)] = float(D[u, hm])
            labels[v][int(hm)] = float(D[v, hm])
    return labels


def query_distance(labels: LabelSets, u: int, v: int) -> float:
    return _query(labels[u], labels[v])


def query_distance_directed(l_out: LabelSets, l_in: LabelSets,
                            u: int, v: int) -> float:
    return _query(l_out[u], l_in[v])


def average_label_size(labels: LabelSets) -> float:
    return sum(len(row) for row in labels) / max(1, len(labels))

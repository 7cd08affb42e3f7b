"""Labeling validators: cover, respects-R, minimality and CHL equality,
the invariants behind the paper's claims. Each raises AssertionError
on the first violation."""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.pll import LabelSets, _query
from repro_torch.graphs.graph import Graph
from repro_torch.sssp.oracle import all_pairs


def _require(cond: bool, *detail) -> None:
    if not cond:
        raise AssertionError(detail)


def check_cover(labels: LabelSets, g: Graph,
                D: Optional[np.ndarray] = None) -> None:
    """Every connected pair's distance is recovered exactly."""
    D = all_pairs(g) if D is None else D
    for u in range(g.n):
        for v in range(g.n):
            got = _query(labels[u], labels[v])
            want = D[u, v]
            if np.isfinite(want):
                _require(got == want, u, v, got, want)
            else:
                _require(not np.isfinite(got), u, v, got)


def check_respects_r(labels: LabelSets, g: Graph, rank: np.ndarray,
                     D: Optional[np.ndarray] = None) -> None:
    """The max-rank vertex over the union of shortest u-v paths is a
    hub of both u and v, with exact distances."""
    D = all_pairs(g) if D is None else D
    for u in range(g.n):
        for v in range(u, g.n):
            if not np.isfinite(D[u, v]):
                continue
            on_path = np.isfinite(D[u]) & np.isfinite(D[v]) & (
                D[u] + D[v] == D[u, v])
            cand = np.nonzero(on_path)[0]
            hm = int(cand[np.argmax(rank[cand])])
            _require(labels[u].get(hm) == D[u, hm], u, v, hm)
            _require(labels[v].get(hm) == D[v, hm], u, v, hm)


def check_equal(labels: LabelSets, ref: LabelSets) -> None:
    """Exact label-set equality (hubs and distances)."""
    _require(len(labels) == len(ref), len(labels), len(ref))
    for v, (a, b) in enumerate(zip(labels, ref)):
        _require(a == b, v, sorted(a.items()), sorted(b.items()))


def check_minimal(labels: LabelSets, g: Graph,
                  D: Optional[np.ndarray] = None) -> None:
    """Removing any one label breaks the cover property."""
    D = all_pairs(g) if D is None else D
    for v in range(g.n):
        for h in list(labels[v].keys()):
            d = labels[v].pop(h)
            broken = any(np.isfinite(D[v, u])
                         and _query(labels[v], labels[u]) != D[v, u]
                         for u in range(g.n))
            labels[v][h] = d
            _require(broken, v, h)


def redundant_count(labels: LabelSets, ref: LabelSets) -> int:
    """Labels present in ``labels`` but not in the reference CHL."""
    return sum(len(set(a) - set(b)) for a, b in zip(labels, ref))

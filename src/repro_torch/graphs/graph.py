"""Core graph container (host numpy) and its move onto a device.

The relaxation engine's unit of work is a padded pull-ELL layout
(``[n, max_deg]`` in-edge source / weight matrices); CSR out-edges are
kept beside it for the Dijkstra oracles and the rankings. The arrays
are byte-identical to the reference package's for the same inputs.

Conventions
-----------
- Vertices are ``int32`` ids in ``[0, n)``.
- Weights are positive ``float32``; integral float weights keep
  path-sum equality exact in f32 (the CHL tie-break relies on it).
- ELL padding: neighbour id ``0`` with weight ``+inf``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A weighted graph in ELL + CSR form (host-resident numpy arrays)."""

    n: int
    m: int                      # number of directed arcs stored
    directed: bool
    # --- ELL (pull direction: in-edges of each vertex) ---
    ell_src: np.ndarray         # int32 [n, max_deg]: source of in-edge
    ell_w: np.ndarray           # float32 [n, max_deg]: weight, inf-padded
    # --- ELL (push direction: out-edges) ---
    ell_dst: np.ndarray         # int32 [n, max_deg_out]
    ell_w_out: np.ndarray       # float32 [n, max_deg_out]
    # --- CSR (out-edges) ---
    indptr: np.ndarray          # int64 [n+1]
    indices: np.ndarray         # int32 [m]
    weights: np.ndarray         # float32 [m]

    @property
    def max_deg_in(self) -> int:
        return int(self.ell_src.shape[1])

    @property
    def max_deg_out(self) -> int:
        return int(self.ell_dst.shape[1])

    def out_edges(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[v], self.indptr[v + 1]
        return self.indices[lo:hi], self.weights[lo:hi]

    def reverse(self) -> "Graph":
        """The graph with every arc reversed (the backward labels of a
        digraph); an undirected graph is its own reverse."""
        if not self.directed:
            return self
        src = np.repeat(np.arange(self.n, dtype=np.int32),
                        np.diff(self.indptr).astype(np.int64))
        return from_edges(self.n, self.indices, src, self.weights,
                          directed=True)


def _build_ell(n: int, heads: np.ndarray, tails: np.ndarray,
               w: np.ndarray, pad_to_multiple: int = 8
               ) -> Tuple[np.ndarray, np.ndarray]:
    """ELL arrays keyed by ``heads``: row v lists (tails, w) of its edges."""
    order = np.argsort(heads, kind="stable")
    heads, tails, w = heads[order], tails[order], w[order]
    deg = np.bincount(heads, minlength=n)
    max_deg = int(deg.max()) if len(heads) else 1
    max_deg = max(1, -(-max_deg // pad_to_multiple) * pad_to_multiple)
    ell_ids = np.zeros((n, max_deg), dtype=np.int32)
    ell_w = np.full((n, max_deg), INF, dtype=np.float32)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    pos = np.arange(len(heads), dtype=np.int64) - starts[heads]
    ell_ids[heads, pos] = tails
    ell_w[heads, pos] = w
    return ell_ids, ell_w


#: bits of a weight in the packed arc sort key of `_arc_order`
_W_BITS = 12


def _arc_order(key: np.ndarray, w: np.ndarray, n: int) -> np.ndarray:
    """The permutation of ``np.lexsort((w, key))``: arcs by key, then
    weight, ties in input order. When every weight is an integer in
    ``[0, 2^12)`` and ``n^2 < 2^52``, one stable argsort of the packed
    ``(key << 12) | w`` gives it several times faster; any other input
    keeps the lexsort."""
    if (len(w) and n * n < 2 ** 52 and float(w.min()) >= 0
            and float(w.max()) < 2 ** _W_BITS
            and bool((w == np.floor(w)).all())):
        packed = (key.astype(np.uint64) << np.uint64(_W_BITS)) \
            | w.astype(np.uint64)
        return np.argsort(packed, kind="stable")
    return np.lexsort((w, key))


def from_edges(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
               directed: bool = False) -> Graph:
    """Build a Graph from an arc list.

    For ``directed=False`` the arcs are symmetrized (both directions
    stored); duplicate arcs keep the minimum weight; self loops drop.
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    order = _arc_order(key, w, n)
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    src, dst, w = src[first], dst[first], w[first]

    m = len(src)
    order = np.argsort(src, kind="stable")
    s, d, ww = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(s, minlength=n), out=indptr[1:])
    ell_dst, ell_w_out = _build_ell(n, src, dst, w)
    ell_src, ell_w = _build_ell(n, dst, src, w)   # in-edges keyed by head
    return Graph(n=n, m=m, directed=directed,
                 ell_src=ell_src, ell_w=ell_w,
                 ell_dst=ell_dst, ell_w_out=ell_w_out,
                 indptr=indptr, indices=d, weights=ww)


def to_networkx(g: Graph):
    """Oracle view (tests only)."""
    import networkx as nx
    G = nx.DiGraph() if g.directed else nx.Graph()
    G.add_nodes_from(range(g.n))
    for v in range(g.n):
        ids, w = g.out_edges(v)
        for u, wt in zip(ids.tolist(), w.tolist()):
            G.add_edge(v, int(u), weight=float(wt))
    return G


class DeviceGraph(NamedTuple):
    """What the relaxation engine reads, resident on one device."""
    ell_src: torch.Tensor    # int32 [n, deg]
    ell_w: torch.Tensor      # f32   [n, deg], +inf padding
    rank: torch.Tensor       # int32 [n]


def device_arrays(g: Graph, rank: np.ndarray,
                  device: DeviceLike = None) -> DeviceGraph:
    """Move the pull-ELL adjacency and the rank onto ``device``
    (default: the card; raises without CUDA)."""
    dev = resolve_device(device)
    return DeviceGraph(
        ell_src=torch.as_tensor(np.asarray(g.ell_src, np.int32),
                                device=dev),
        ell_w=torch.as_tensor(np.asarray(g.ell_w, np.float32), device=dev),
        rank=torch.as_tensor(np.asarray(rank).astype(np.int32),
                             device=dev))

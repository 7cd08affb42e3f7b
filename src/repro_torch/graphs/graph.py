"""Core graph container (host numpy) and its move onto a device.

The relaxation engine's unit of work is a degree-capped pull-ELL layout
(``[n, width]`` in-edge source / weight matrices, ``width`` the largest
in-degree up to `ELL_CAP`) with a hub tail beside it: a vertex's
in-edges past the cap, as arcs sorted by destination, in the order the
uncapped row would list them. CSR out-edges are kept beside it for the
Dijkstra oracles and the rankings. A graph whose largest in-degree is
at most the cap has an empty tail, and its arrays are byte-identical to
the reference package's for the same inputs; a wider one's ELL is the
first `ELL_CAP` columns of the reference's and its tail the rest
(`cap_ell`).

Conventions
-----------
- Vertices are ``int32`` ids in ``[0, n)``.
- Weights are positive ``float32``; integral float weights keep
  path-sum equality exact in f32 (the CHL tie-break relies on it).
- ELL padding: neighbour id ``0`` with weight ``+inf``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ell_relax.tail import EllTail

INF = np.float32(np.inf)

#: the pull ELL's widest row: a vertex's in-edges past this many go to
#: the graph's tail, so a heavy-tailed graph's ELL stays ``[n, ELL_CAP]``
#: (GAP's kron at scale 22, largest degree 162,809, would pad to 5.5 TB).
#: At least 72, so GAP's urand at scale 22 (ELL width 72) keeps its
#: arrays; a multiple of the ELL's padding of 8
ELL_CAP = 128


@dataclasses.dataclass(frozen=True)
class Graph:
    """A weighted graph in capped ELL + tail + CSR form (host-resident
    numpy arrays)."""

    n: int
    m: int                      # number of directed arcs stored
    directed: bool
    # --- ELL (pull direction: in-edges of each vertex) ---
    ell_src: np.ndarray         # int32 [n, width]: source of in-edge
    ell_w: np.ndarray           # float32 [n, width]: weight, inf-padded
    # --- the tail: in-edges past the ELL's ELL_CAP columns ---
    tail_dst: np.ndarray        # int32 [T]: destination, ascending
    tail_src: np.ndarray        # int32 [T]
    tail_w: np.ndarray          # float32 [T]
    # --- CSR (out-edges) ---
    indptr: np.ndarray          # int64 [n+1]
    indices: np.ndarray         # int32 [m]
    weights: np.ndarray         # float32 [m]

    @property
    def max_deg_in(self) -> int:
        """The ELL's width (the largest in-degree, capped, padded)."""
        return int(self.ell_src.shape[1])

    @property
    def tail_arcs(self) -> int:
        return int(self.tail_dst.shape[0])

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


Tail = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _empty_tail() -> Tail:
    return (np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))


def _build_ell(n: int, heads: np.ndarray, tails: np.ndarray,
               w: np.ndarray, pad_to_multiple: int = 8
               ) -> Tuple[np.ndarray, np.ndarray, Tail]:
    """Capped ELL arrays keyed by ``heads``: row v lists (tails, w) of
    its first `ELL_CAP` edges; the rest form the tail ``(heads, tails,
    w)``, sorted by head, each head's edges in row order."""
    order = np.argsort(heads, kind="stable")
    heads, tails, w = heads[order], tails[order], w[order]
    deg = np.bincount(heads, minlength=n)
    max_deg = int(deg.max()) if len(heads) else 1
    width = max(1, -(-min(max_deg, ELL_CAP) // pad_to_multiple)
                * pad_to_multiple)
    ell_ids = np.zeros((n, width), dtype=np.int32)
    ell_w = np.full((n, width), INF, dtype=np.float32)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    pos = np.arange(len(heads), dtype=np.int64) - starts[heads]
    tail = _empty_tail()
    if max_deg > width:
        past = pos >= width
        tail = (heads[past], tails[past], w[past])
        keep = ~past
        heads, tails, w, pos = heads[keep], tails[keep], w[keep], pos[keep]
    ell_ids[heads, pos] = tails
    ell_w[heads, pos] = w
    return ell_ids, ell_w, tail


def cap_ell(ell_src: np.ndarray, ell_w: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, Tail]:
    """A pull ELL padded to its largest in-degree (the reference
    package's) capped as `from_edges` caps it: ``(ell_src, ell_w,
    (tail_dst, tail_src, tail_w))``."""
    ell_src = np.asarray(ell_src, np.int32)
    ell_w = np.asarray(ell_w, np.float32)
    if ell_src.shape[1] <= ELL_CAP:
        return ell_src, ell_w, _empty_tail()
    rest_s, rest_w = ell_src[:, ELL_CAP:], ell_w[:, ELL_CAP:]
    # nonzero lists the entries row-major: by destination, in row order
    rows, cols = np.nonzero(np.isfinite(rest_w))
    return (np.ascontiguousarray(ell_src[:, :ELL_CAP]),
            np.ascontiguousarray(ell_w[:, :ELL_CAP]),
            (rows.astype(np.int32), rest_s[rows, cols], rest_w[rows, cols]))


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
    # in-edges keyed by head
    ell_src, ell_w, (t_dst, t_src, t_w) = _build_ell(n, dst, src, w)
    return Graph(n=n, m=m, directed=directed,
                 ell_src=ell_src, ell_w=ell_w,
                 tail_dst=t_dst, tail_src=t_src, tail_w=t_w,
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
    tail: Optional[EllTail] = None   # in-edges past the ELL's cap


def device_adjacency(g: Graph, device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[EllTail]]:
    """The pull-ELL adjacency on ``device`` (default: the card; raises
    without CUDA): ``(ell_src, ell_w, tail)``, the tail None for an
    empty one. A caller that sweeps it passes the tail to the sweeps'
    layout (`sssp.relax.ell_layout`, `kernels.ell_relax.tail`)."""
    dev = resolve_device(device)
    ell_src = torch.as_tensor(np.asarray(g.ell_src, np.int32), device=dev)
    ell_w = torch.as_tensor(np.asarray(g.ell_w, np.float32), device=dev)
    tail = None
    if g.tail_arcs:
        tail = EllTail(
            dst=torch.as_tensor(np.asarray(g.tail_dst, np.int32),
                                device=dev),
            src=torch.as_tensor(np.asarray(g.tail_src, np.int32),
                                device=dev),
            w=torch.as_tensor(np.asarray(g.tail_w, np.float32),
                              device=dev))
    return ell_src, ell_w, tail


def device_arrays(g: Graph, rank: np.ndarray,
                  device: DeviceLike = None) -> DeviceGraph:
    """Move the pull-ELL adjacency, its tail and the rank onto
    ``device`` (default: the card; raises without CUDA)."""
    dev = resolve_device(device)
    ell_src, ell_w, tail = device_adjacency(g, dev)
    return DeviceGraph(
        ell_src=ell_src, ell_w=ell_w,
        rank=torch.as_tensor(np.asarray(rank).astype(np.int32),
                             device=dev),
        tail=tail)

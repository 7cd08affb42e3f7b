"""Plain reference: the canonical hub labels of the top-ranked roots.

Independent of the port (plain PyTorch; it imports nothing of
`repro_torch`). From the edge list, the ranking and the traffic's root
schedule it works out:

1. the roots: the ``trees`` vertices of highest rank, in rank order;
2. exact distances from each root: delta-stepping over a CSR adjacency
   built here from the edge list (both directions, self loops dropped,
   a repeated pair relaxed by each of its weights);
3. the labels. (root r, vertex v) is canonical iff no vertex of higher
   rank than r lies on any shortest r-v path. Vertex x lies on one iff
   d(r, x) + d(x, v) == d(r, v). The roots top the rank order, so the
   vertices that outrank root k are roots 0..k-1, and the test needs
   only the roots' own distances;
4. the label table as the port lays it out: a vertex's labels in root
   order, padded with (-1, +inf), counts beside them.

``dtype`` is the precision of the distances (float64: exact; the
control runs it in bfloat16).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: edges relaxed at once (bounds the temporaries of a round)
CHUNK_EDGES = 1 << 25


def top_roots(rank: np.ndarray, trees: int) -> np.ndarray:
    """The first ``trees`` vertices in descending rank order."""
    order = np.argsort(-np.asarray(rank, dtype=np.int64), kind="stable")
    return order[:trees].astype(np.int64)


class Csr(NamedTuple):
    indptr: torch.Tensor   # int64 [n + 1]
    col: torch.Tensor      # int64 [arcs]
    w: torch.Tensor        # dtype [arcs]


def csr(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
        dtype: torch.dtype, device) -> Csr:
    s = torch.as_tensor(src, device=device).long()
    d = torch.as_tensor(dst, device=device).long()
    ww = torch.as_tensor(w, device=device).to(dtype)
    s, d, ww = torch.cat([s, d]), torch.cat([d, s]), torch.cat([ww, ww])
    keep = s != d
    s, d, ww = s[keep], d[keep], ww[keep]
    order = torch.argsort(s)
    indptr = torch.zeros(n + 1, dtype=torch.long, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(s, minlength=n), 0)
    return Csr(indptr, d[order], ww[order])


def sssp(n: int, g: Csr, roots: np.ndarray, dtype: torch.dtype
         ) -> torch.Tensor:
    """``[len(roots), n]`` shortest distances in ``dtype`` (+inf where
    unreachable), by delta-stepping: each round relaxes the out-arcs of
    the pending (tree, vertex) pairs whose distance fell since they were
    last relaxed and lies below the bucket's bound; when none does, the
    bound moves to the least pending distance plus ``delta`` (twice the
    largest weight). Exact for any ``delta``: a pending pair is relaxed
    again whenever its distance falls."""
    dev = g.indptr.device
    k = len(roots)
    delta = 2 * float(g.w.max()) if g.w.numel() else 1.0
    pending = torch.arange(k, device=dev) * n + torch.as_tensor(roots,
                                                               device=dev)
    dist = torch.full((k * n,), torch.inf, dtype=dtype, device=dev)
    dist[pending] = 0
    queued = torch.zeros(k * n, dtype=torch.bool, device=dev)
    queued[pending] = True
    bound = delta
    while pending.numel():
        act = dist[pending] < bound
        front = pending[act]
        if front.numel() == 0:
            bound = float(dist[pending].min()) + delta
            continue
        pending = pending[~act]
        queued[front] = False
        tree = torch.div(front, n, rounding_mode="floor")
        u = front - tree * n
        start = g.indptr[u]
        deg = g.indptr[u + 1] - start
        ends = torch.cumsum(deg, 0)
        fresh = []
        lo = 0
        while lo < front.numel():
            # the longest run of frontier pairs with at most CHUNK_EDGES
            # arcs (at least one pair)
            done = int(ends[lo - 1]) if lo else 0
            hi = int(torch.searchsorted(ends, done + CHUNK_EDGES,
                                        right=True))
            hi = max(hi, lo + 1)
            dg = deg[lo:hi]
            total = int(ends[hi - 1]) - done
            if total:
                rep = torch.repeat_interleave(
                    torch.arange(hi - lo, device=dev), dg,
                    output_size=total)
                first = (ends[lo:hi] - dg - done)[rep]
                e = start[lo:hi][rep] + torch.arange(total, device=dev) \
                    - first
                cand = dist[front[lo:hi][rep]] + g.w[e]
                key = tree[lo:hi][rep] * n + g.col[e]
                old = dist[key]
                dist.scatter_reduce_(0, key, cand, "amin")
                fresh.append(key[cand < old])
            lo = hi
        if fresh:
            new = torch.unique(torch.cat(fresh))
            new = new[~queued[new]]
            queued[new] = True
            pending = torch.cat([pending, new])
    return dist.view(k, n)


class Table(NamedTuple):
    hubs: torch.Tensor    # int32 [n, cap], -1 padding
    dist: torch.Tensor    # f32 [n, cap], +inf padding
    count: torch.Tensor   # int32 [n]


def canonical_table(dist: torch.Tensor, roots: np.ndarray, cap: int,
                    k_done: int) -> Table:
    """The labels of roots ``0..k_done-1`` (in root order) from their
    distances ``dist[k, v]``, computed in ``dist``'s dtype; ``roots``
    must be the top of the rank order. Labels past ``cap`` are dropped
    and the count clamped, as a label table does."""
    k_all, n = dist.shape
    dev = dist.device
    hubs = torch.full((n, cap), -1, dtype=torch.int32, device=dev)
    out = torch.full((n, cap), torch.inf, dtype=torch.float32, device=dev)
    count = torch.zeros(n, dtype=torch.int64, device=dev)
    v = torch.arange(n, device=dev)
    roots_d = torch.as_tensor(roots, device=dev)
    for k in range(k_done):
        d = dist[k]
        emit = torch.isfinite(d)
        for j in range(k):
            # root j outranks root k: no label where it lies on a path
            emit &= d[roots_d[j]] + dist[j] > d
        ok = emit & (count < cap)
        flat = (v * cap + count)[ok]
        hubs.view(-1)[flat] = int(roots[k])
        out.view(-1)[flat] = d[ok].to(torch.float32)
        count += emit
    return Table(hubs, out, torch.clamp(count, max=cap).to(torch.int32))


class Reference:
    """The reference labels of one cell's inputs: distances once, tables
    for any prefix of the roots."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 w: np.ndarray, rank: np.ndarray, *, trees: int,
                 cap: int, device, dtype=torch.float64):
        self.roots = top_roots(rank, trees)
        self.cap = int(cap)
        g = csr(n, src, dst, w, dtype, device)
        self.dist = sssp(n, g, self.roots, dtype)

    def table(self, k_done: int) -> Table:
        return canonical_table(self.dist, self.roots, self.cap, k_done)

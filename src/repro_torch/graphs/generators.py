"""Synthetic graph generators mirroring the paper's dataset families.

Road networks (high diameter, low degree) and scale-free networks
(heavy-tailed degree), with the paper's weighting for unweighted
inputs: integer weights uniform in ``[1, sqrt(n))`` as integral floats
so path-sum ties are exact. Same seeds give the same arrays as the
reference package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph, from_edges


def _weights(rng: np.random.Generator, m: int, n: int,
             max_w: int | None = None) -> np.ndarray:
    hi = max(2, int(np.sqrt(n))) if max_w is None else max_w
    return rng.integers(1, hi, size=m).astype(np.float32)


def grid_road(rows: int, cols: int, seed: int = 0,
              diag_frac: float = 0.1, max_w: int | None = None) -> Graph:
    """Road-network-like 2D lattice with a sprinkling of diagonal
    shortcuts: high diameter, degree <= ~6."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    vid = np.arange(n).reshape(rows, cols)
    src, dst = [], []
    src.append(vid[:, :-1].ravel()); dst.append(vid[:, 1:].ravel())
    src.append(vid[:-1, :].ravel()); dst.append(vid[1:, :].ravel())
    n_diag = int(diag_frac * n)
    if n_diag and rows > 1 and cols > 1:
        r = rng.integers(0, rows - 1, n_diag)
        c = rng.integers(0, cols - 1, n_diag)
        src.append(vid[r, c]); dst.append(vid[r + 1, c + 1])
    src = np.concatenate(src).astype(np.int32)
    dst = np.concatenate(dst).astype(np.int32)
    w = _weights(rng, len(src), n, max_w)
    return from_edges(n, src, dst, w, directed=False)


def scale_free(n: int, attach: int = 2, seed: int = 0,
               max_w: int | None = None, directed: bool = False) -> Graph:
    """Barabási–Albert preferential attachment: core-fringe structure."""
    rng = np.random.default_rng(seed)
    attach = min(attach, n - 1)
    src, dst = [], []
    targets = list(range(attach))
    repeated: list[int] = list(range(attach))
    for v in range(attach, n):
        for t in set(targets):
            src.append(v); dst.append(t)
        repeated.extend(targets)
        repeated.extend([v] * attach)
        idx = rng.integers(0, len(repeated), size=attach)
        targets = [repeated[i] for i in idx]
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w = _weights(rng, len(src), n, max_w)
    return from_edges(n, src, dst, w, directed=directed)


def random_geometric(n: int, radius: float | None = None, seed: int = 0,
                     max_w: int | None = None) -> Graph:
    """Random geometric graph (unit square), connected w.h.p.; joined
    into one component by `_ensure_connected` when it is not."""
    rng = np.random.default_rng(seed)
    if radius is None:
        radius = float(np.sqrt(3.0 * np.log(max(n, 2)) / (np.pi * n)))
    pts = rng.random((n, 2))
    src, dst = [], []
    # O(n^2) pair scan, i < j in order (the weights are drawn in it);
    # test scale only
    for i in range(n):
        d2 = np.sum((pts[i + 1:] - pts[i]) ** 2, axis=1)
        js = np.nonzero(d2 <= radius * radius)[0] + i + 1
        src.extend([i] * len(js)); dst.extend(js.tolist())
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w = _weights(rng, len(src), n, max_w)
    g = from_edges(n, src, dst, w, directed=False)
    return _ensure_connected(g, rng, max_w)


def random_connected(n: int, extra_edges: int, seed: int = 0,
                     max_w: int | None = None,
                     directed: bool = False) -> Graph:
    """Random spanning tree + ``extra_edges`` chords (always connected;
    small and tie-heavy)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)
    heads = perm[1:]
    tails = perm[rng.integers(0, np.arange(1, n))] if n > 1 else perm[:0]
    src = [heads]; dst = [tails]
    if extra_edges:
        src.append(rng.integers(0, n, extra_edges).astype(np.int32))
        dst.append(rng.integers(0, n, extra_edges).astype(np.int32))
    src = np.concatenate(src); dst = np.concatenate(dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = _weights(rng, len(src), n, max_w)
    if directed:
        # reverse tree arcs too, so everything is mutually reachable
        w2 = _weights(rng, len(heads), n, max_w)
        s = np.concatenate([src, tails]); d = np.concatenate([dst, heads])
        ww = np.concatenate([w, w2])
        return from_edges(n, s, d, ww, directed=True)
    return from_edges(n, src, dst, w, directed=False)


def _components(g: Graph) -> list[set]:
    """The connected components of an undirected graph as Python sets,
    in order of their first vertex, each built by a breadth-first search
    from it that visits neighbours in ascending id (the order of the
    CSR rows, and of `to_networkx`'s adjacency) and adds vertices in
    visiting order, so that set iteration matches networkx's
    ``connected_components`` on the same interpreter."""
    indptr, indices = g.indptr.tolist(), g.indices.tolist()
    adj = [indices[indptr[v]:indptr[v + 1]] for v in range(g.n)]
    seen_all: set = set()
    comps = []
    for v in range(g.n):
        if v in seen_all:
            continue
        seen = {v}
        level = [v]
        while level:
            nxt = []
            for x in level:
                for y in adj[x]:
                    if y not in seen:
                        seen.add(y)
                        nxt.append(y)
            level = nxt
        seen_all |= seen
        comps.append(seen)
    return comps


def _ensure_connected(g: Graph, rng: np.random.Generator,
                      max_w: int | None) -> Graph:
    """Link the connected components into a chain with random-weight
    edges between their representatives (tests only)."""
    comps = _components(g)
    if len(comps) == 1:
        return g
    src = np.repeat(np.arange(g.n, dtype=np.int32),
                    np.diff(g.indptr).astype(np.int64))
    extra_s, extra_d = [], []
    reps = [next(iter(c)) for c in comps]
    for a, b in zip(reps[:-1], reps[1:]):
        extra_s.append(a); extra_d.append(b)
    s = np.concatenate([src, np.asarray(extra_s, np.int32)])
    d = np.concatenate([g.indices, np.asarray(extra_d, np.int32)])
    w = np.concatenate([g.weights, _weights(rng, len(extra_s), g.n, max_w)])
    return from_edges(g.n, s, d, w, directed=False)

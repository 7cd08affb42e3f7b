"""GAP's `urand` graph: uniformly random endpoints, joined by a path.

`edge_factor * n` edges with both endpoints uniform in [0, n) (the GAP
Benchmark Suite's generator, self loops dropped, the rare repeated pair
kept: the graph keeps its least weight), plus a path through a random
permutation of the vertices, so the graph is connected and no vertex
gains more than two edges by it. Integer weights uniform in
[1, sqrt(n)). One fixed draw (``structure_seed``): the configuration's
``relabel`` has each run serve it under its own vertex numbering, so
every seed brings the same work (a batch's sweeps, which the fixpoint
check rounds to a multiple of 4, would otherwise move by 10 %).
"""

from __future__ import annotations

import numpy as np


def edges(cfg: dict, rng: np.random.Generator):
    """``(n, src, dst, w)``: the undirected edge list (int32 endpoints,
    float32 integral weights); ``rng`` is not drawn from."""
    del rng
    rng = np.random.default_rng(int(cfg["structure_seed"]))
    n = 1 << int(cfg["scale"])
    if n != int(cfg["n"]):
        raise ValueError(f"2^scale = {n} != n = {cfg['n']}")
    m = int(cfg["edge_factor"]) * n
    src = rng.integers(0, n, size=m, dtype=np.int32)
    dst = rng.integers(0, n, size=m, dtype=np.int32)
    keep = src != dst
    perm = rng.permutation(n).astype(np.int32)
    src = np.concatenate([src[keep], perm[:-1]])
    dst = np.concatenate([dst[keep], perm[1:]])
    hi = max(2, int(np.sqrt(n)))
    w = rng.integers(1, hi, size=len(src)).astype(np.float32)
    return n, src, dst, w

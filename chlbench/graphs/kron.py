"""GAP's `kron` graph: the Graph500 Kronecker generator, unjoined.

`edge_factor * n` edges (n = 2^scale), each endpoint pair drawn bit by
bit over ``scale`` levels from the initiator matrix [[A, B], [C, D]]
(Graph500's A = 0.57, B = C = 0.19, D = 0.05, which GAP's kron uses): at
each level one uniform float32 per edge picks the quadrant (below A,
A + B, A + B + C, or past them), C or D setting the source's bit and B
or D the destination's. The draws run in blocks of `BLOCK` edges, all
levels of a block at once, so that a block's arrays stay in cache. The
vertex ids are then permuted by one random permutation, as Graph500
permutes them. Self loops are dropped; a repeated pair is kept in the
list (the graph keeps its least weight). Integer weights uniform in
[1, sqrt(n)). No joining path: GAP's kron is not joined, so the
vertices no edge reaches stay isolated. One fixed draw
(``structure_seed``), numbering included, as GAP's kron is one
generated graph file: every seed brings the same work.
"""

from __future__ import annotations

import numpy as np

#: edges whose levels are drawn together (part of the frozen draw)
BLOCK = 1 << 16


def require_capped_ell() -> None:
    """Refuse, before the draw, a port whose pull ELL is padded to the
    largest in-degree (one with no ``repro_torch.graphs.graph.ELL_CAP``):
    this graph's largest hub (~163,000 in-edges at scale 22) would pad
    it to ~5.5 TB, and the host would kill the run for memory part-way
    through the build instead of it failing."""
    try:
        from repro_torch.graphs import graph
    except ImportError:
        return                      # no port: the driver fails on its own
    if not hasattr(graph, "ELL_CAP"):
        raise RuntimeError("kron: this port pads its pull ELL to the "
                           "largest in-degree (no ELL_CAP and hub tail), "
                           "which cannot hold a Kronecker graph's hubs")


def edges(cfg: dict, rng: np.random.Generator):
    """``(n, src, dst, w)``: the undirected edge list (int32 endpoints,
    float32 integral weights); ``rng`` is not drawn from. Refuses a port
    that cannot lay the graph out (`require_capped_ell`)."""
    del rng
    require_capped_ell()
    rng = np.random.default_rng(int(cfg["structure_seed"]))
    scale = int(cfg["scale"])
    n = 1 << scale
    if n != int(cfg["n"]):
        raise ValueError(f"2^scale = {n} != n = {cfg['n']}")
    m = int(cfg["edge_factor"]) * n
    init = cfg["initiator"]
    a, ab, abc = (np.float32(x) for x in np.cumsum(
        [init["A"], init["B"], init["C"]]))
    src = np.zeros(m, dtype=np.int32)
    dst = np.zeros(m, dtype=np.int32)
    r = np.empty(BLOCK, dtype=np.float32)
    s_bit, d_bit = np.empty(BLOCK, dtype=bool), np.empty(BLOCK, dtype=bool)
    bits = np.empty(BLOCK, dtype=np.int32)
    for lo in range(0, m, BLOCK):
        k = min(BLOCK, m - lo)
        s_out, d_out = src[lo:lo + k], dst[lo:lo + k]
        rk, sk, dk, bk = r[:k], s_bit[:k], d_bit[:k], bits[:k]
        for level in range(scale):
            rng.random(out=rk, dtype=np.float32)
            np.greater_equal(rk, ab, out=sk)                  # C or D
            # B or D: past A but not A + B, or past A + B + C
            np.greater_equal(rk, a, out=dk)
            dk ^= sk
            dk ^= rk >= abc
            np.left_shift(sk, level, out=bk, dtype=np.int32)
            s_out |= bk
            np.left_shift(dk, level, out=bk, dtype=np.int32)
            d_out |= bk
    perm = rng.permutation(n).astype(np.int32)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    hi = max(2, int(np.sqrt(n)))
    w = rng.integers(1, hi, size=len(src)).astype(np.float32)
    return n, src, dst, w

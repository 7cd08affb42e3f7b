"""Dense-block PLaNT over the (min, +) kernel: the device dispatch, the
dense weight block, the full sweep with its epilogue and the fixpoint
driver.

The dense path serves the paper's core regime: the few highest-rank
trees dominate both work and label mass and traverse the dense
scale-free core, where a regular blocked (min, +) product replaces the
sparse gather. The sparse ELL engine (`repro_torch.sssp.relax`) stays
the general one.
"""

from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.minplus.minplus import minplus
from repro_torch.kernels.minplus.ref import minplus_plain


def minplus_product(dist, mrank, w):
    """Lexicographic (min, +) product of dist f32 / mrank i32 [B, K] and
    w f32 [K, N]: the hand-written kernel on CUDA tensors (any shape, no
    padding), the plain version on CPU ones; no fallback between them."""
    if dist.device.type == "cuda":
        return minplus(dist, mrank, w)
    if dist.device.type != "cpu":
        raise ValueError(f"minplus_product: no kernel for {dist.device}")
    return minplus_plain(dist, mrank, w)


def dense_weights(g, device: DeviceLike = None) -> torch.Tensor:
    """Dense f32 [n, n] edge-weight block (+inf off-edge) of a Graph,
    built on ``device`` (default: the card) with one ``index_put_``.
    ``from_edges`` has dropped duplicate arcs, so the write is
    deterministic."""
    dev = resolve_device(device)
    n = g.n
    w = torch.full((n, n), torch.inf, dtype=torch.float32, device=dev)
    indptr = torch.as_tensor(g.indptr, device=dev)
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  indptr[1:] - indptr[:-1])
    w.index_put_((src, torch.as_tensor(g.indices, device=dev).long()),
                 torch.as_tensor(g.weights, device=dev))
    return w


def plant_sweep_dense(dist, mrank, w, rank):
    """One full PLaNT relaxation sweep on a dense block: the (min, +)
    product, then the min-with-self and keep/through max-rank epilogue
    of the ELL sweep."""
    od, om = minplus_product(dist, mrank, w)
    new_dist = torch.minimum(dist, od)
    through = torch.where((od <= new_dist) & (om >= 0),
                          torch.maximum(om, rank[None, :]), -1)
    keep = torch.where(dist <= new_dist, mrank, -1)
    return new_dist, torch.maximum(keep, through)


def plant_fixpoint_dense(w, rank, roots):
    """Dense-block PLaNT: relax the trees rooted at ``roots`` to
    fixpoint over w f32 [n, n]; returns (dist f32 [B, n], mrank i32
    [B, n], emit bool [B, n]).

    The reference's stopping rule: sweep while the last sweep changed a
    plane and fewer than n sweeps ran (one host sync per sweep).
    """
    n = w.shape[0]
    dev = w.device
    roots = roots.to(dev).long()
    rank = rank.to(dev).to(torch.int32)
    B = roots.shape[0]
    ar = torch.arange(B, device=dev)
    dist = torch.full((B, n), torch.inf, dtype=torch.float32, device=dev)
    dist[ar, roots] = 0.0
    mrank = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    mrank[ar, roots] = rank[roots]
    it, changed = 0, True
    while changed and it < n:
        nd, nm = plant_sweep_dense(dist, mrank, w, rank)
        changed = bool(((nd < dist) | (nm != mrank)).any())
        dist, mrank, it = nd, nm, it + 1
    emit = (mrank == rank[roots][:, None]) & torch.isfinite(dist)
    return dist, mrank, emit

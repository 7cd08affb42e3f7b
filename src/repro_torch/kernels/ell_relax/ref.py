"""Plain PyTorch version of the fused ELL relaxation sweep.

``ell_sweep_ref`` is the reference package's oracle op for op: the
caller passes ``prop = where(blocked | ~frontier, +inf, dist)`` and
``+inf`` sources contribute no candidates. ``ell_sweep_plain`` adds the
kernel's per-tree retirement: trees with ``alive == False`` pass
through unchanged. Both read the ELL alone unless given a hub ``tail``,
which they fold beside it; only oracles pass one (tests, ``kernel_ab.py``),
since a tailed adjacency sweeps through its layout.
``ell_sweep_bucketed_plain`` is the windowed kernel's plain version: the
same function over the segments of a source-bucketed layout, the ELL's
and the tail's arcs alike.

Arcs outside the dense ELL, a tail's or a layout's, fold through one
helper, `fold_arcs`: the exact (min, then max rank at the min) per
destination, by scatter, which no order of the arcs changes over exact
floats. These functions run on any device; the CPU path of
`ops.ell_sweep` and the card-side parity checks both call them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.ell_relax.tail import EllTail

#: (dst, src, w) of a run of arcs: i32 [E] destination and source, f32
#: [E] finite weight
Arcs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fold_arcs(dist: torch.Tensor, best: torch.Tensor, prop: torch.Tensor,
              prop_mrank: torch.Tensor, runs: Sequence[Arcs]):
    """Fold runs of arcs into each destination: (new_dist, best_in).

    ``new_dist`` is the min of ``dist``, ``best`` (candidates folded
    already, ``+inf`` where none) and each arc's ``prop[:, src] + w``;
    ``best_in`` the max ``prop_mrank[:, src]`` over the arcs whose finite
    candidate attains it, -1 where none does: a min pass over all runs,
    then the max-at-min pass."""
    B = dist.shape[0]
    new_dist = torch.minimum(dist, best)
    for dst, src, w in runs:
        new_dist = new_dist.scatter_reduce(
            1, dst.long().expand(B, -1), prop[:, src.long()] + w[None, :],
            "amin")
    best_in = torch.full_like(prop_mrank, -1)
    for dst, src, w in runs:
        d, s = dst.long().expand(B, -1), src.long()
        cand = prop[:, s] + w[None, :]
        att = (cand <= new_dist.gather(1, d)) & torch.isfinite(cand)
        best_in = best_in.scatter_reduce(
            1, d, torch.where(att, prop_mrank[:, s], -1), "amax")
    return new_dist, best_in


def _settle(dist, mrank, new_dist, best_in, rank):
    """The sweep's outputs from the folded (new_dist, best_in)."""
    through = torch.where(best_in >= 0,
                          torch.maximum(best_in, rank[None, :]), -1)
    keep = torch.where(dist <= new_dist, mrank, -1)
    return new_dist, torch.maximum(keep, through)


def ell_sweep_ref(dist: torch.Tensor, mrank: torch.Tensor,
                  prop: torch.Tensor, prop_mrank: torch.Tensor,
                  ell_src: torch.Tensor, ell_w: torch.Tensor,
                  rank: torch.Tensor, *, tail: Optional[EllTail] = None):
    """One relaxation sweep. dist/mrank/prop/prop_mrank [B, n];
    ell_* [n, deg]; rank [n]; ``tail``: in-edges beside the ELL's,
    folded into the same (min, max-at-min) per destination. Returns
    (new_dist, new_mrank)."""
    idx = ell_src.long()
    nd = prop[:, idx]                           # [B, n, deg]
    nm = prop_mrank[:, idx]
    cand = nd + ell_w[None, :, :]
    best = cand.amin(dim=-1)                    # [B, n]
    if tail is None:
        new_dist = torch.minimum(dist, best)
    else:
        new_dist, tail_in = fold_arcs(dist, best, prop, prop_mrank, [tail])
    attains = (cand <= new_dist[..., None]) & torch.isfinite(cand)
    best_in = torch.where(attains, nm, -1).amax(dim=-1)
    if tail is not None:
        best_in = torch.maximum(best_in, tail_in)
    return _settle(dist, mrank, new_dist, best_in, rank)


def ell_sweep_plain(dist, mrank, prop, alive, ell_src, ell_w, rank, *,
                    tail: Optional[EllTail] = None):
    """`ell_sweep_ref` with ``prop_mrank = mrank`` and retired trees
    (``alive[b] == False``) copied through — the dense kernel's
    function, and with ``tail`` that of ELL + tail."""
    nd, nm = ell_sweep_ref(dist, mrank, prop, mrank, ell_src, ell_w, rank,
                           tail=tail)
    a = alive[:, None]
    return torch.where(a, nd, dist), torch.where(a, nm, mrank)


#: elements of one edge block's [B, edges] gather in
#: `ell_sweep_bucketed_plain`, so that a full-size call stays in memory
BLOCK_ELEMS = 1 << 26


def ell_sweep_bucketed_plain(dist, mrank, prop, alive, layout, rank):
    """`ell_sweep_plain` over a source-bucketed layout (`BucketedEll`),
    the windowed kernel's function: the reference's
    ``ell_sweep_bucketed_ref`` with per-tree retirement.

    Folds the layout's segments, the adjacency's finite arcs (its hub
    tail's included), with `fold_arcs`; rows without a segment
    (``bare_rows``) have no candidate. Edges run in blocks of
    ``BLOCK_ELEMS`` gathered elements, which changes nothing in the
    result.
    """
    B = dist.shape[0]
    seg = layout.segments
    dst = torch.repeat_interleave(seg.seg_row, seg.seg_ptr.diff())
    step = max(1, BLOCK_ELEMS // max(1, B))
    runs = [(dst[lo:lo + step], seg.edge_src[lo:lo + step],
             seg.edge_w[lo:lo + step])
            for lo in range(0, dst.numel(), step)]
    new_dist, best_in = fold_arcs(dist, torch.full_like(dist, torch.inf),
                                  prop, mrank, runs)
    nd, nm = _settle(dist, mrank, new_dist, best_in, rank.to(torch.int32))
    a = alive[:, None]
    return torch.where(a, nd, dist), torch.where(a, nm, mrank)

"""Plain PyTorch version of the fused ELL relaxation sweep.

``ell_sweep_ref`` is the reference package's oracle op for op: the
caller passes ``prop = where(blocked | ~frontier, +inf, dist)`` and
``+inf`` sources contribute no candidates. ``ell_sweep_plain`` adds the
kernel's per-tree retirement: trees with ``alive == False`` pass
through unchanged. It runs on any device; the CPU path of
`ops.ell_sweep` and the card-side parity checks both call it.
"""

from __future__ import annotations

import torch


def ell_sweep_ref(dist: torch.Tensor, mrank: torch.Tensor,
                  prop: torch.Tensor, prop_mrank: torch.Tensor,
                  ell_src: torch.Tensor, ell_w: torch.Tensor,
                  rank: torch.Tensor):
    """One relaxation sweep. dist/mrank/prop/prop_mrank [B, n];
    ell_* [n, deg]; rank [n]. Returns (new_dist, new_mrank)."""
    idx = ell_src.long()
    nd = prop[:, idx]                           # [B, n, deg]
    nm = prop_mrank[:, idx]
    cand = nd + ell_w[None, :, :]
    best = cand.amin(dim=-1)                    # [B, n]
    new_dist = torch.minimum(dist, best)
    attains = (cand <= new_dist[..., None]) & torch.isfinite(cand)
    best_in = torch.where(attains, nm, -1).amax(dim=-1)
    through = torch.where(best_in >= 0,
                          torch.maximum(best_in, rank[None, :]), -1)
    keep = torch.where(dist <= new_dist, mrank, -1)
    return new_dist, torch.maximum(keep, through)


def ell_sweep_plain(dist, mrank, prop, alive, ell_src, ell_w, rank):
    """`ell_sweep_ref` with ``prop_mrank = mrank`` and retired trees
    (``alive[b] == False``) copied through — the kernel's function."""
    nd, nm = ell_sweep_ref(dist, mrank, prop, mrank, ell_src, ell_w, rank)
    a = alive[:, None]
    return torch.where(a, nd, dist), torch.where(a, nm, mrank)

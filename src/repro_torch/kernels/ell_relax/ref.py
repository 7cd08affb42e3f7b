"""Plain PyTorch version of the fused ELL relaxation sweep.

``ell_sweep_ref`` is the reference package's oracle op for op: the
caller passes ``prop = where(blocked | ~frontier, +inf, dist)`` and
``+inf`` sources contribute no candidates. ``ell_sweep_plain`` adds the
kernel's per-tree retirement: trees with ``alive == False`` pass
through unchanged, and folds the adjacency's hub tail
(`tail.tail_of`) beside the ELL; ``ell_sweep_bucketed_plain`` is the
same function over a source-bucketed layout, the windowed kernel's
plain version.
They run on any device; the CPU path of `ops.ell_sweep` and the
card-side parity checks both call them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ell_relax.tail import EllTail, tail_of


def ell_sweep_ref(dist: torch.Tensor, mrank: torch.Tensor,
                  prop: torch.Tensor, prop_mrank: torch.Tensor,
                  ell_src: torch.Tensor, ell_w: torch.Tensor,
                  rank: torch.Tensor, tail: Optional[EllTail] = None):
    """One relaxation sweep. dist/mrank/prop/prop_mrank [B, n];
    ell_* [n, deg]; rank [n]; ``tail``: in-edges beside the ELL's,
    folded into the same (min, max-at-min) per destination. Returns
    (new_dist, new_mrank)."""
    idx = ell_src.long()
    nd = prop[:, idx]                           # [B, n, deg]
    nm = prop_mrank[:, idx]
    cand = nd + ell_w[None, :, :]
    best = cand.amin(dim=-1)                    # [B, n]
    if tail is not None:
        dst = tail.dst.long().expand(dist.shape[0], -1)
        t_src = tail.src.long()
        t_cand = prop[:, t_src] + tail.w[None, :]
        best = best.scatter_reduce(1, dst, t_cand, "amin")
    new_dist = torch.minimum(dist, best)
    attains = (cand <= new_dist[..., None]) & torch.isfinite(cand)
    best_in = torch.where(attains, nm, -1).amax(dim=-1)
    if tail is not None:
        t_att = (t_cand <= new_dist.gather(1, dst)) & torch.isfinite(t_cand)
        best_in = best_in.scatter_reduce(
            1, dst, torch.where(t_att, prop_mrank[:, t_src], -1), "amax")
    through = torch.where(best_in >= 0,
                          torch.maximum(best_in, rank[None, :]), -1)
    keep = torch.where(dist <= new_dist, mrank, -1)
    return new_dist, torch.maximum(keep, through)


def ell_sweep_plain(dist, mrank, prop, alive, ell_src, ell_w, rank):
    """`ell_sweep_ref` with ``prop_mrank = mrank``, the adjacency's tail
    and retired trees (``alive[b] == False``) copied through — the
    kernel's function."""
    nd, nm = ell_sweep_ref(dist, mrank, prop, mrank, ell_src, ell_w, rank,
                           tail_of(ell_src, ell_w))
    a = alive[:, None]
    return torch.where(a, nd, dist), torch.where(a, nm, mrank)


#: elements of one row block's [B, rows, width] gather in
#: `ell_sweep_bucketed_plain`, so that a full-size call stays in memory
BLOCK_ELEMS = 1 << 26


def _pad_plane(x: torch.Tensor, n_pad: int, fill) -> torch.Tensor:
    pad = n_pad - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad), value=fill) if pad > 0 \
        else x


def ell_sweep_bucketed_plain(dist, mrank, prop, alive, layout, rank):
    """`ell_sweep_plain` over a source-bucketed layout (`BucketedEll`):
    the reference's ``ell_sweep_bucketed_ref`` with per-tree retirement.

    Global sources are the window-local ``layout.src`` plus each chunk's
    window base; the source planes are padded to ``layout.n_pad``. Rows
    run in blocks of ``BLOCK_ELEMS`` gathered elements, which changes
    nothing in the result: each row's fold reads only its own slots.
    """
    B, n = dist.shape
    n_pad, bn, dk = layout.n_pad, layout.bn, layout.dk
    p = _pad_plane(prop, n_pad, torch.inf)
    m = _pad_plane(mrank, n_pad, -1)
    rank = rank.to(torch.int32)
    width = layout.src.shape[1]
    step = max(bn, BLOCK_ELEMS // max(1, B * width) // bn * bn)
    out_d, out_m = [], []
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        tiles = torch.arange(lo, hi, device=dist.device) // bn
        gsrc = (layout.src[lo:hi] + layout.chunk_win[tiles]
                .repeat_interleave(dk, dim=1) * layout.window)
        nd, nm = ell_sweep_ref(dist[:, lo:hi], mrank[:, lo:hi], p, m,
                               gsrc, layout.w[lo:hi], rank[lo:hi])
        out_d.append(nd)
        out_m.append(nm)
    nd, nm = torch.cat(out_d, dim=1), torch.cat(out_m, dim=1)
    a = alive[:, None]
    return torch.where(a, nd, dist), torch.where(a, nm, mrank)

"""Plain PyTorch version of the lexicographic (min, +) product."""

from __future__ import annotations

import torch

#: elements of one K chunk's [B, chunk, N] candidate cube, so that a
#: full-size call (B = 64, K = N = 32,768: a 275 GB cube) stays in
#: memory
CHUNK_ELEMS = 1 << 26


def minplus_plain(dist: torch.Tensor, mrank: torch.Tensor,
                  w: torch.Tensor):
    """out_d[b, v] = min_u dist[b, u] + w[u, v]; out_m[b, v] = max
    mrank[b, u] over the u whose finite candidate attains the min (-1 if
    none).

    Folds over K in chunks with the reference kernel's lexicographic
    rule (min the distances; keep each side's rank where it attains the
    new min; take the max), which over exact values is bit-identical to
    the one-shot reduction.
    """
    B, K = dist.shape
    N = w.shape[1]
    out_d = torch.full((B, N), torch.inf, dtype=torch.float32,
                       device=dist.device)
    out_m = torch.full((B, N), -1, dtype=torch.int32, device=dist.device)
    step = max(1, CHUNK_ELEMS // max(1, B * N))
    for lo in range(0, K, step):
        cand = dist[:, lo:lo + step, None] + w[None, lo:lo + step, :]
        tile_d = cand.amin(dim=1)                            # [B, N]
        attain = (cand <= tile_d[:, None, :]) & torch.isfinite(cand)
        tile_m = torch.where(attain, mrank[:, lo:lo + step, None],
                             -1).amax(dim=1).to(torch.int32)
        new_d = torch.minimum(out_d, tile_d)
        keep_acc = torch.where(out_d <= new_d, out_m, -1)
        keep_new = torch.where(tile_d <= new_d, tile_m, -1)
        out_d, out_m = new_d, torch.maximum(keep_acc, keep_new)
    return out_d, out_m

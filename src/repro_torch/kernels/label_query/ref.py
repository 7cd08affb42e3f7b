"""Plain PyTorch version of the label-intersection kernel.

Exactly the reference package's ``labels.query_pairs`` intersection:
the least ``du[i] + dv[j]`` over ``hu[i] == hv[j] >= 0`` (``+inf`` when
the hub sets are disjoint) and the hub at the first row-major index
attaining it (``-1`` when the distance is not finite).
"""

from __future__ import annotations

import torch


def label_query_ref(hubs_u: torch.Tensor, dist_u: torch.Tensor,
                    hubs_v: torch.Tensor, dist_v: torch.Tensor):
    """hubs_* i32 / dist_* f32 [Q, L] -> (dist f32 [Q], hub i32 [Q])."""
    Q, L = hubs_u.shape
    match = (hubs_u[:, :, None] == hubs_v[:, None, :]) & (
        hubs_u[:, :, None] >= 0)
    dd = torch.where(match, dist_u[:, :, None] + dist_v[:, None, :],
                     torch.inf).reshape(Q, L * L)
    if Q == 0:
        return dist_u.new_empty(0), hubs_u.new_empty(0)
    best = dd.amin(dim=-1)
    flat = dd.argmin(dim=-1)                    # first index of the min
    hub_at = torch.gather(hubs_u, 1, (flat // L)[:, None])[:, 0]
    hub = torch.where(torch.isfinite(best), hub_at, -1)
    return best, hub

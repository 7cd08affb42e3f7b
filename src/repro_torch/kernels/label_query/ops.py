"""`query_table`: the serving hot path — gather the label rows of a
(u, v) query batch from a label table and intersect them.

On CUDA tensors the intersection is the hand-written kernel at any
label width; on CPU tensors it is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.label_query.label_query import label_query
from repro_torch.kernels.label_query.ref import label_query_ref


def intersect(hubs_u, dist_u, hubs_v, dist_v):
    """(dist, hub) of gathered label rows, dispatched by device."""
    if hubs_u.device.type == "cuda":
        return label_query(hubs_u, dist_u, hubs_v, dist_v)
    if hubs_u.device.type != "cpu":
        raise ValueError(f"label_query: no kernel for {hubs_u.device}")
    return label_query_ref(hubs_u, dist_u, hubs_v, dist_v)


def query_table(table, u: torch.Tensor, v: torch.Tensor):
    """PPSD(u[i], v[i]) over a `LabelTable`: (dist f32 [Q], hub i32 [Q];
    +inf / -1 when disjoint). ``u``/``v`` are index tensors on the
    table's device."""
    return intersect(table.hubs[u], table.dist[u],
                     table.hubs[v], table.dist[v])

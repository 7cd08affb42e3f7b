"""`query_table`: the serving hot path — the label rows of a (u, v)
query batch, read from a label table and intersected; `query_table_pair`
reads u's rows from one table and v's from another (a directed query);
`query_rows` intersects rows already gathered (the spill and compressed
stores gather and decode their rows first).

On CUDA tensors each is one launch of the hand-written kernel: the
table forms read the rows themselves (`label_query_rows`,
`label_query_pair_rows`), `query_rows` takes the operand form
(`label_query`). On CPU tensors it is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.label_query.label_query import (
    check_same_shape, label_query, label_query_pair_rows, label_query_rows)
from repro_torch.kernels.label_query.ref import label_query_ref


def query_table(table, u, v):
    """PPSD(u[i], v[i]) over a `LabelTable`: (dist f32 [Q], hub i32 [Q];
    +inf / -1 when disjoint). ``u``/``v`` are index tensors on the
    table's device (int64 on the card; negative ids wrap). A CUDA table
    must keep `label_query_rows`' precondition: ``(-1, +inf)`` at and
    past each row's count."""
    dev = table.hubs.device
    if dev.type == "cuda":
        return label_query_rows(table.hubs, table.dist, table.count, u, v)
    if dev.type != "cpu":
        raise ValueError(f"label_query: no kernel for {dev}")
    return label_query_ref(table.hubs[u], table.dist[u],
                           table.hubs[v], table.dist[v])


def query_table_pair(table_u, table_v, u, v):
    """min over common hubs of ``table_u[u[i]]`` and ``table_v[v[i]]``:
    (dist f32 [Q], hub i32 [Q]; +inf / -1 when disjoint), the witness
    from ``table_u``'s row. Both tables on one device; CUDA tables of one
    shape keeping `label_query_rows`' precondition."""
    dev = table_u.hubs.device
    if dev.type == "cuda":
        return label_query_pair_rows(table_u, table_v, u, v)
    if dev.type != "cpu":
        raise ValueError(f"label_query: no kernel for {dev}")
    check_same_shape(table_u, table_v)
    return label_query_ref(table_u.hubs[u], table_u.dist[u],
                           table_v.hubs[v], table_v.dist[v])


#: f32 elements of one chunk's ``[q, L, L]`` intersection temporary in
#: the plain `query_rows`: bounds transient host RAM on the spill path,
#: whose whole point is indexes larger than RAM
ROWS_BUDGET = 1 << 22


def query_rows(hubs_u, dist_u, hubs_v, dist_v):
    """min over common hubs of gathered rows hubs_* i32 / dist_* f32
    ``[Q, L]``: (dist f32 [Q], hub i32 [Q]; +inf / -1 when disjoint), the
    witness the u-side hub at the first row-major argmin. On the card one
    launch of the operand form; on the CPU the plain version in chunks
    of Q whose ``[q, L, L]`` temporary holds at most `ROWS_BUDGET`
    elements."""
    dev = hubs_u.device
    if dev.type == "cuda":
        return label_query(hubs_u, dist_u, hubs_v, dist_v)
    if dev.type != "cpu":
        raise ValueError(f"label_query: no kernel for {dev}")
    Q, L = hubs_u.shape
    step = max(1, ROWS_BUDGET // max(1, L * L))
    if step >= Q:
        return label_query_ref(hubs_u, dist_u, hubs_v, dist_v)
    parts = [label_query_ref(hubs_u[s:s + step], dist_u[s:s + step],
                             hubs_v[s:s + step], dist_v[s:s + step])
             for s in range(0, Q, step)]
    return (torch.cat([d for d, _ in parts]),
            torch.cat([h for _, h in parts]))

"""`query_table`: the serving hot path — the label rows of a (u, v)
query batch, read from a label table and intersected; `query_table_pair`
reads u's rows from one table and v's from another (a directed query).

On CUDA tables each is one launch of the hand-written kernel, which
reads the rows itself (`label_query_rows`, `label_query_pair_rows`); on
CPU tables it is the plain PyTorch version over the gathered rows.
"""

from __future__ import annotations

from repro_torch.kernels.label_query.label_query import (
    check_same_shape, label_query_pair_rows, label_query_rows)
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

"""`query_table`: the serving hot path — the label rows of a (u, v)
query batch, read from a label table and intersected.

On a CUDA table this is one launch of the hand-written kernel, which
reads the rows itself (`label_query_rows`); on a CPU table it is the
plain PyTorch version over the gathered rows.
"""

from __future__ import annotations

from repro_torch.kernels.label_query.label_query import label_query_rows
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

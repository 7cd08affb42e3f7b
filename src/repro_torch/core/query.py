"""Distributed PPSD query serving — QLSN / QFDL / QDOL (§6).

- **QLSN**: every node holds all labels; the querying node intersects
  locally. Memory O(n·ALS) *per node*.
- **QFDL**: labels partitioned by hub (the construction-time layout);
  a query is broadcast, each node computes a partial min over its hub
  partition, and `pmin` (the paper's MPI_MIN) reduces. Memory
  O(n·ALS/q) per node.
- **QDOL**: vertices split into ζ partitions with C(ζ, 2) <= q; node k
  stores the *full* label rows of partition pair (i, j) and alone
  answers queries with endpoints in (i, j). Query ids go to every node
  (the analog of the paper's routed batch: each query is *answered* by
  exactly one node), non-owners contribute +inf, and one `pmin`
  combines. Memory O(2·n·ALS/ζ), about O(n·ALS/sqrt(q)) per node.

On the card, QLSN and each node's QFDL partial are one launch each of
the table form of the hand-written ``label_query`` kernel; each node's
QDOL intersection is one launch of its operand form over the rows the
node gathers. On the CPU the plain versions run.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core.labels import LabelTable, total_labels
from repro_torch.index.store.dense import as_index
from repro_torch.kernels.label_query import query_rows, query_table
from repro_torch.parallel import collectives as coll


# --------------------------------------------------------------------
# QLSN
# --------------------------------------------------------------------

def qlsn(table: LabelTable, u, v) -> torch.Tensor:
    """Single-node query: the min over common hubs (f32 [Q], on the
    table's device)."""
    dev = table.hubs.device
    return query_table(table, as_index(u, dev), as_index(v, dev))[0]


# --------------------------------------------------------------------
# QFDL
# --------------------------------------------------------------------

def qfdl_fn(mesh):
    """Query over the hub-partitioned tables (one ``[n, L]`` table a
    node, on the node's device): each node's partial min, then `pmin`.
    Returns ``f(partitioned, u, v) -> dist f32 [Q]`` on node 0's
    device."""
    def f(partitioned, u, v) -> torch.Tensor:
        if len(partitioned) != mesh.q:
            raise ValueError(f"{len(partitioned)} partitions for a mesh "
                             f"of {mesh.q} nodes")
        parts = [query_table(t, as_index(u, d), as_index(v, d))[0]
                 for t, d in zip(partitioned, mesh.devices)]
        return coll.pmin(parts)[0]
    return f


# --------------------------------------------------------------------
# QDOL
# --------------------------------------------------------------------

class QdolLayout(NamedTuple):
    zeta: int
    pairs: np.ndarray         # [q, 2] partition pair per node (-1 idle)
    part_of: np.ndarray       # [n] vertex -> partition
    node_of_pair: np.ndarray  # [zeta, zeta] -> node id


def qdol_layout(n: int, q: int) -> QdolLayout:
    """zeta = the largest integer with C(zeta, 2) <= q (the paper's
    zeta = (1 + sqrt(1 + 8q)) / 2)."""
    zeta = max(2, int((1 + np.sqrt(1 + 8 * q)) / 2))
    while zeta * (zeta - 1) // 2 > q:
        zeta -= 1
    pairs = np.full((q, 2), -1, dtype=np.int32)
    node_of_pair = np.zeros((zeta, zeta), dtype=np.int32)
    k = 0
    for i in range(zeta):
        for j in range(i + 1, zeta):
            pairs[k] = (i, j)
            node_of_pair[i, j] = node_of_pair[j, i] = k
            k += 1
    for i in range(zeta):                      # same-partition queries
        node_of_pair[i, i] = node_of_pair[i, (i + 1) % zeta]
    part_of = (np.arange(n) * zeta // max(1, n)).astype(np.int32)
    return QdolLayout(zeta=zeta, pairs=pairs, part_of=part_of,
                      node_of_pair=node_of_pair)


class QdolStore(NamedTuple):
    hubs: List[torch.Tensor]   # per node [S, L]: rows of its 2 partitions
    dist: List[torch.Tensor]   # per node [S, L]
    slot: List[torch.Tensor]   # per node [n]: vertex -> local row (-1)


def qdol_build(table: LabelTable, layout: QdolLayout, mesh) -> QdolStore:
    """Per-node overlapping label stores from a full table (host numpy,
    as the reference builds them), node k's on its device."""
    n, L = table.hubs.shape
    q = layout.pairs.shape[0]
    sizes = np.bincount(layout.part_of, minlength=layout.zeta)
    S = int(sizes.max()) * 2
    hubs = np.full((q, S, L), -1, dtype=np.int32)
    dist = np.full((q, S, L), np.inf, dtype=np.float32)
    slot = np.full((q, n), -1, dtype=np.int32)
    th = table.hubs.cpu().numpy()
    td = table.dist.cpu().numpy()
    for k in range(q):
        i, j = layout.pairs[k]
        if i < 0:
            continue
        verts = np.nonzero((layout.part_of == i) | (layout.part_of == j))[0]
        hubs[k, :len(verts)] = th[verts]
        dist[k, :len(verts)] = td[verts]
        slot[k, verts] = np.arange(len(verts), dtype=np.int32)
    return QdolStore(
        hubs=[torch.as_tensor(hubs[k], device=d)
              for k, d in enumerate(mesh.devices)],
        dist=[torch.as_tensor(dist[k], device=d)
              for k, d in enumerate(mesh.devices)],
        slot=[torch.as_tensor(slot[k], device=d)
              for k, d in enumerate(mesh.devices)])


def qdol_fn(mesh, layout: QdolLayout):
    """``f(store, u, v) -> dist f32 [Q]`` on node 0's device: each node
    answers the queries whose partition pair it owns (+inf elsewhere),
    then `pmin`."""
    node_of_pair = mesh.replicate(
        lambda d: torch.as_tensor(layout.node_of_pair.astype(np.int64),
                                  device=d))
    part_of = mesh.replicate(
        lambda d: torch.as_tensor(layout.part_of.astype(np.int64),
                                  device=d))

    def f(store: QdolStore, u, v) -> torch.Tensor:
        parts = []
        for me, d in enumerate(mesh.devices):
            uu, vv = as_index(u, d), as_index(v, d)
            target = node_of_pair[me][part_of[me][uu], part_of[me][vv]]
            su = store.slot[me][uu].long()
            sv = store.slot[me][vv].long()
            ok = (target == me) & (su >= 0) & (sv >= 0)
            su = torch.where(ok, su, 0)
            sv = torch.where(ok, sv, 0)
            hubs, dist = store.hubs[me], store.dist[me]
            ans, _ = query_rows(hubs[su], dist[su], hubs[sv], dist[sv])
            parts.append(torch.where(ok, ans, torch.inf))
        return coll.pmin(parts)[0]                  # exactly 1 responder
    return f


def label_memory_bytes(table: LabelTable) -> int:
    """Bytes to store the (hub, dist) pairs actually present."""
    return total_labels(table) * 8


def mode_memory_totals(n: int, base_bytes: int, q: int) -> dict:
    """Per-mode total label storage across a cluster of ``q`` nodes
    (Table 4), from the resident label bytes alone."""
    zeta = qdol_layout(n, q).zeta
    return {
        "qlsn_total": base_bytes * q,         # replicated everywhere
        "qfdl_total": base_bytes,             # partitioned by hub
        # each of C(zeta, 2) nodes stores ~2·base/zeta: total ~base·(zeta-1)
        "qdol_total": base_bytes * (zeta - 1),
        "q": q, "zeta": zeta,
    }


def mode_memory_report(table: LabelTable, q: int) -> dict:
    """Table-4 memory report for a dense label table."""
    return mode_memory_totals(table.n, label_memory_bytes(table), q)

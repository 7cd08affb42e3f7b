"""Host-side helpers of the query modes (§6): the QDOL partition layout
and the per-mode label-memory totals (Table 4). The distributed query
functions (``qfdl_fn``, ``qdol_fn``) wait for the distributed slice
(ROADMAP Queue 1, item 11).

- QLSN: every node holds all labels, O(n·ALS) per node;
- QFDL: labels partitioned by hub, O(n·ALS/q) per node;
- QDOL: vertices split into zeta partitions with C(zeta, 2) <= q; node k
  stores the full label rows of partition pair (i, j), about
  O(2·n·ALS/zeta) per node.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.labels import LabelTable, total_labels


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

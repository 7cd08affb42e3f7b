"""Fixed-capacity padded hub-label tables.

The paper's per-vertex label vectors become one padded table:

    hubs : int32 [n, L]   (-1 = empty slot)
    dist : f32   [n, L]   (+inf = empty slot)
    count: int32 [n]

Slot order and padding are those of the reference package, so tables
compare array for array.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.label_query.ref import label_query_ref


class LabelOverflowError(RuntimeError):
    """A fixed-capacity label table ran out of slots; carries ``cap``
    so `repro_torch.index.build` can retry with a grown capacity."""

    def __init__(self, cap: int, what: str = "label table"):
        super().__init__(f"{what} overflow (cap={cap}); raise `cap`")
        self.cap = cap
        self.what = what


def default_cap(n: int) -> int:
    """Default per-vertex label capacity: ``4·sqrt(n) + 32``, at least
    16, at most n."""
    return min(max(16, 4 * int(np.sqrt(n)) + 32), max(1, n))


class LabelTable(NamedTuple):
    hubs: torch.Tensor    # i32 [n, L]
    dist: torch.Tensor    # f32 [n, L]
    count: torch.Tensor   # i32 [n]

    @property
    def n(self) -> int:
        return self.hubs.shape[0]

    @property
    def cap(self) -> int:
        return self.hubs.shape[1]


def empty(n: int, cap: int, device) -> LabelTable:
    return LabelTable(
        hubs=torch.full((n, cap), -1, dtype=torch.int32, device=device),
        dist=torch.full((n, cap), torch.inf, dtype=torch.float32,
                        device=device),
        count=torch.zeros(n, dtype=torch.int32, device=device))


def insert_batch(table: LabelTable, roots: torch.Tensor, emit: torch.Tensor,
                 dists: torch.Tensor) -> Tuple[LabelTable, torch.Tensor]:
    """Append labels ``(roots[b], dists[b, v])`` for every ``emit[b, v]``.

    Updates the table's tensors in place (the caller owns them; this
    saves a copy of the ``[n, cap]`` table per batch) and returns it
    with a bool overflow flag: any vertex whose count would exceed the
    capacity. Labels past the capacity are dropped and the count is
    clamped to it.
    """
    n, cap = table.n, table.cap
    B = roots.shape[0]
    off = torch.cumsum(emit.to(torch.int64), dim=0) - 1           # [B, n]
    pos = table.count[None, :].to(torch.int64) + off              # [B, n]
    ok = emit & (pos < cap)
    vert = torch.arange(n, device=emit.device, dtype=torch.int64)
    flat = (vert[None, :] * cap + pos)[ok]
    hub_vals = roots.to(torch.int32)[:, None].expand(B, n)[ok]
    table.hubs.view(-1)[flat] = hub_vals
    table.dist.view(-1)[flat] = dists[ok]
    new_count = table.count + emit.sum(dim=0, dtype=torch.int32)
    overflow = (new_count > cap).any()
    table.count.copy_(torch.clamp(new_count, max=cap))
    return table, overflow


def check_padding(table: LabelTable) -> None:
    """Raise ValueError unless ``0 <= count <= cap`` and every slot at or
    past a row's count holds ``(-1, +inf)``: the contract under which the
    card's `label_query_rows`, which reads a row only below its count,
    equals the plain query over the padded rows. One pass over the table
    and one host sync."""
    slot = torch.arange(table.cap, device=table.hubs.device)
    past = slot[None, :] >= table.count[:, None]
    broken = (past & ((table.hubs != -1) | (table.dist != torch.inf))).any()
    broken |= ((table.count < 0) | (table.count > table.cap)).any()
    if bool(broken):
        raise ValueError("label table breaks the padding contract: every "
                         "slot at or past count must hold (-1, +inf), with "
                         "0 <= count <= cap")


def query_pairs(table: LabelTable, u: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched PPSD query, plain version: min over common hubs of
    d(u,x) + d(v,x) and the first row-major witnessing hub (-1 when
    disjoint)."""
    return label_query_ref(table.hubs[u], table.dist[u],
                           table.hubs[v], table.dist[v])


def total_labels(table: LabelTable) -> int:
    return int(table.count.sum())

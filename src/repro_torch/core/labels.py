"""Fixed-capacity padded hub-label tables.

The paper's per-vertex label vectors become one padded table:

    hubs : int32 [n, L]   (-1 = empty slot)
    dist : f32   [n, L]   (+inf = empty slot)
    count: int32 [n]

Slot order and padding are those of the reference package, so tables
compare array for array. The distance-query cover of GLL/LCC
(`cover_distance`, `cover_best_rank`) builds a ``[b, n, L]``
intermediate; it runs in chunks of its first axis so that one chunk's
intermediate stays within `COVER_CHUNK_BYTES`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.label_query.ref import label_query_ref

#: bytes of one chunk's f32 ``[b, n, L]`` intermediate in `cover_distance`
#: and `cover_best_rank` (at least one row of the first axis a chunk)
COVER_CHUNK_BYTES = 1 << 30


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


def hub_distance_map(table: LabelTable, roots: torch.Tensor) -> torch.Tensor:
    """Dense map ``hmap[b, x] = d(roots[b], x)`` for x in L_{roots[b]},
    ``+inf`` elsewhere: a scatter-min over the roots' label rows, in
    which padding slots write ``+inf`` at hub 0."""
    n = table.n
    rh = table.hubs[roots.long()]                            # [B, L]
    rd = table.dist[roots.long()]
    B = rh.shape[0]
    row = torch.arange(B, device=rh.device, dtype=torch.int64)[:, None]
    flat = row * n + torch.where(rh >= 0, rh, 0).long()
    hmap = torch.full((B * n,), torch.inf, dtype=torch.float32,
                      device=rh.device)
    hmap.scatter_reduce_(0, flat.reshape(-1),
                         torch.where(rh >= 0, rd, torch.inf).reshape(-1),
                         "amin", include_self=True)
    return hmap.view(B, n)


def _chunk_rows(table: LabelTable) -> int:
    """Rows of the first axis a cover chunk takes: its f32 ``[b, n, L]``
    intermediate within `COVER_CHUNK_BYTES`, and at least one row."""
    return max(1, COVER_CHUNK_BYTES // max(1, 4 * table.n * table.cap))


def cover_distance(table: LabelTable, hmap: torch.Tensor) -> torch.Tensor:
    """``cover[b, v] = min_{x in L_v} hmap[b, x] + d(v, x)``: the
    distance query DQ(v, root_b) for every vertex, in chunks of b."""
    safe_h = torch.where(table.hubs >= 0, table.hubs, 0).long()   # [n, L]
    dist = torch.where(table.hubs >= 0, table.dist, torch.inf)
    step = _chunk_rows(table)
    return torch.cat([(hmap[s:s + step][:, safe_h] + dist).amin(dim=-1)
                      for s in range(0, hmap.shape[0], step)])


def cover_best_rank(table: LabelTable, hmap: torch.Tensor,
                    rank: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Max rank over hubs x common to L_v and the root's map with
    ``hmap[b, x] + d(v, x) <= delta[b, v]`` (-1 if none): DQ_Clean's
    witness, in chunks of b."""
    safe_h = torch.where(table.hubs >= 0, table.hubs, 0).long()
    rank_h = torch.where(table.hubs >= 0, rank[safe_h].to(torch.int32), -1)
    step = _chunk_rows(table)
    out = []
    for s in range(0, hmap.shape[0], step):
        via = hmap[s:s + step][:, safe_h] + table.dist            # [b, n, L]
        good = via <= delta[s:s + step, :, None]
        out.append(torch.where(good, rank_h, -1).amax(dim=-1))
    return torch.cat(out)


def merge(a: LabelTable, b: LabelTable) -> Tuple[LabelTable, torch.Tensor]:
    """Append all labels of ``b`` after those of ``a`` (same n) into a
    new table; labels past ``a``'s capacity are dropped, the count is
    clamped, and the bool flag says whether any row overflowed."""
    n, cap = a.n, a.cap
    idx = torch.arange(b.cap, device=b.hubs.device)[None, :]
    pos = a.count[:, None].to(torch.int64) + idx              # [n, Lb]
    ok = (idx < b.count[:, None]) & (pos < cap)
    vert = torch.arange(n, device=b.hubs.device, dtype=torch.int64)
    flat = (vert[:, None] * cap + pos)[ok]
    hubs, dist = a.hubs.clone(), a.dist.clone()
    hubs.view(-1)[flat] = b.hubs[ok]
    dist.view(-1)[flat] = b.dist[ok]
    new_count = a.count + b.count
    overflow = (new_count > cap).any()
    return LabelTable(hubs, dist, torch.clamp(new_count, max=cap)), overflow


def delete_mask(table: LabelTable, drop: torch.Tensor) -> LabelTable:
    """Remove labels where ``drop[n, L]`` is True, compacting each row
    (a stable sort: the kept labels keep their order)."""
    keep = ~drop & (table.hubs >= 0)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    hubs = torch.gather(table.hubs, 1, order)
    dist = torch.gather(table.dist, 1, order)
    kept = keep.sum(dim=1, dtype=torch.int32)
    live = torch.arange(table.cap, device=keep.device)[None, :] < kept[:, None]
    return LabelTable(torch.where(live, hubs, -1),
                      torch.where(live, dist, torch.inf), kept)


def to_numpy_sets(table: LabelTable) -> list[dict[int, float]]:
    """Host view: per vertex ``{hub: dist}``; a hub repeated in a row
    keeps its least distance."""
    hubs = table.hubs.cpu().numpy()
    dist = table.dist.cpu().numpy()
    count = table.count.cpu().numpy()
    n, cap = hubs.shape
    mask = (np.arange(cap)[None, :] < count[:, None]) & (hubs >= 0)
    v_idx, k_idx = np.nonzero(mask)
    h = hubs[v_idx, k_idx].astype(np.int64)
    d = dist[v_idx, k_idx].astype(float)
    order = np.lexsort((d, h, v_idx))
    v_s, h_s, d_s = v_idx[order], h[order], d[order]
    first = np.ones(len(v_s), dtype=bool)
    first[1:] = (v_s[1:] != v_s[:-1]) | (h_s[1:] != h_s[:-1])
    out: list[dict[int, float]] = [{} for _ in range(n)]
    for v, hub, dd in zip(v_s[first].tolist(), h_s[first].tolist(),
                          d_s[first].tolist()):
        out[v][hub] = dd
    return out


def from_numpy_sets(sets: list[dict[int, float]], cap: int | None = None,
                    device: DeviceLike = None) -> LabelTable:
    """Pack per-vertex ``{hub: dist}`` dicts into a padded table on
    ``device`` (default: the card), hubs ascending in each row; raises
    `LabelOverflowError` when a row holds more than ``cap`` labels."""
    dev = resolve_device(device)
    n = len(sets)
    need = max((len(s) for s in sets), default=0)
    cap = max(need, 1) if cap is None else cap
    if need > cap:
        raise LabelOverflowError(cap)
    hubs = np.full((n, cap), -1, dtype=np.int32)
    dist = np.full((n, cap), np.inf, dtype=np.float32)
    count = np.zeros(n, dtype=np.int32)
    for v, row in enumerate(sets):
        for k, (h, d) in enumerate(sorted(row.items())):
            hubs[v, k] = h
            dist[v, k] = d
        count[v] = len(row)
    return LabelTable(torch.as_tensor(hubs, device=dev),
                      torch.as_tensor(dist, device=dev),
                      torch.as_tensor(count, device=dev))


def total_labels(table: LabelTable) -> int:
    return int(table.count.sum())

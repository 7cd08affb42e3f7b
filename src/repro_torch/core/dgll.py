"""DGLL — distributed GLL over a node mesh (§5.1, §5.3).

The paper's MPI design on a :class:`~repro_torch.parallel.mesh.NodeMesh`:

- roots are assigned round-robin by rank: node ``i`` owns ``TQ_i = {v :
  order_index(v) mod q == i}``;
- **label-set partitioning**: node ``i`` stores only the labels whose
  hub it generated, in its own ``[n, L]`` table on its device (the
  reference's ``[q, n, L]`` table sharded on the node axis);
- supersteps grow geometrically by ``beta`` (synchronization points set
  a priori, §5.1);
- superstep sync: new labels are all-gathered (the paper's broadcast);
  every node answers all cleaning queries against *its* partition (a
  witness hub ``w`` lives on ``owner(w)``, with both its ``(w -> v)`` and
  ``(w -> h)`` labels), and the per-node best-witness ranks are combined
  with `pmax` (the paper's redundancy-bitvector all-reduce);
- optional **Common Label Table** (§5.3): the top-η hubs' labels,
  replicated on every node, prune construction (and the Hybrid's
  PLaNTed trees).

A superstep runs as stages over the q per-node states, with the
collectives of `repro_torch.parallel.collectives` between them: stage A
constructs every node's trees (each batch tentatively inserted into a
copy of the node's own table, so that later batches of the superstep
prune against it), then the gathers, stage B (each node's partial
verdict), `pmax`, and stage C (each node's final insert). Every node's
stage A finishes before any node's stage B starts, as the reference's
nodes run in lockstep under ``shard_map``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core.gll import construct_batch
from repro_torch.core.labels import LabelTable
from repro_torch.core.plant import plant_batch
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import NodeMesh, make_node_mesh

__all__ = ["DistState", "NodeGraph", "SuperstepOut", "assign_roots",
           "dgll_chl", "dgll_superstep_fn", "init_dist_state",
           "make_node_mesh", "merge_partitions", "stack_partitions"]


def assign_roots(rank: np.ndarray, q: int) -> np.ndarray:
    """Round-robin root queues: ``queues[i, k]`` = the k-th root of node
    i (descending rank), padded with -1. Paper §5.1: R(v) mod q = i."""
    order = np.argsort(-rank.astype(np.int64), kind="stable")
    n = len(order)
    per = -(-n // q)
    queues = np.full((q, per), -1, dtype=np.int32)
    for i in range(q):
        chunk = order[i::q]
        queues[i, :len(chunk)] = chunk
    return queues


class NodeGraph(NamedTuple):
    """One node's copy of the graph operands, on its device."""
    ell_src: torch.Tensor    # i32 [n, deg]
    ell_w: torch.Tensor      # f32 [n, deg]
    rank: torch.Tensor       # i32 [n]
    layout: object           # the sweeps' BucketedEll, or None (dense)


class SuperstepOut(NamedTuple):
    table: List[LabelTable]              # per node [n, L]
    new_labels: List[torch.Tensor]       # i32 [] labels committed
    explored: List[torch.Tensor]         # i32 [] vertices touched (Ψ)
    overflow: List[torch.Tensor]         # bool [] table capacity hit
    compact_overflow: List[torch.Tensor]  # bool [] §Perf-2 budget hit


class DistState(NamedTuple):
    table: List[LabelTable]   # per node [n, L], on the node's device
    hc: List[LabelTable]      # per node [n, Lhc]: the replicated table


def init_dist_state(mesh: NodeMesh, n: int, cap: int,
                    hc_cap: int) -> DistState:
    """Empty per-node partitions (distinct tensors even where nodes
    share a device) and an empty common label table."""
    return DistState(
        table=[lbl.empty(n, cap, d) for d in mesh.devices],
        hc=mesh.replicate(lambda d: lbl.empty(n, hc_cap, d)))


def _clone(t: LabelTable) -> LabelTable:
    return LabelTable(t.hubs.clone(), t.dist.clone(), t.count.clone())


def _compact_part(work: LabelTable, hmap: torch.Tensor, rank: torch.Tensor,
                  ids: torch.Tensor, val: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """Best witness rank for each broadcast label ``(h_b -> ids[b, k],
    d[b, k])`` on this node: the max rank over hubs ``w`` of the label
    row ``L_v`` (v = ids[b, k]) with ``hmap[b, w] + d(v, w) <= d[b, k]``,
    -1 if none; ``[B, K]``, in chunks of b.

    The reference intersects ``L_v`` with ``L_h`` pairwise (a ``[.., L,
    L]`` match). This reads ``L_h`` through its hub map instead (the
    least ``d(h, w)`` a hub ``w`` of ``L_h`` carries; +inf elsewhere):
    since f32 addition is monotone, ``d(v, w) + min_i d_i(h, w) <= delta``
    holds iff some pair does, so the verdicts are the same.
    """
    B, K = ids.shape
    L = work.cap
    step = max(1, lbl.COVER_CHUNK_BYTES // max(1, 4 * K * L))
    out = []
    for s in range(0, B, step):
        ib = ids[s:s + step].long()                      # [b, K]
        hv = work.hubs[ib]                               # [b, K, L]
        ok = (hv >= 0) & val[s:s + step, :, None]
        safe = torch.where(hv >= 0, hv, 0).long()
        b = ib.shape[0]
        via = torch.gather(hmap[s:s + step], 1,
                           safe.reshape(b, K * L)).reshape(b, K, L)
        via = via + work.dist[ib]
        good = ok & (via <= d[s:s + step, :, None])
        out.append(torch.where(good, rank[safe].to(torch.int32),
                               -1).amax(dim=-1))
    return torch.cat(out)


def dgll_superstep_fn(mesh: NodeMesh, n: int, batch: int, use_hc: bool,
                      plant_trees: bool, compact: int = 0):
    """The superstep over the mesh: ``step(tables, hc, graph, roots,
    valid) -> SuperstepOut``, where ``tables``, ``hc`` and ``graph`` hold
    one entry a node and ``roots``/``valid`` are the host ``[q, T]``
    queue slices (-1 / False on padding). The nodes' tables are updated
    in place.

    ``plant_trees=True`` gives the Hybrid's PLaNT phase: construction by
    PLaNT (optionally HC-pruned), labels already canonical — **no
    gather, no cleaning, no collective call**. Otherwise: DGLL
    construction + broadcast cleaning.

    ``compact > 0`` (§Perf-2) broadcasts each tree's labels (at most
    ``compact`` ``(vertex, distance)`` pairs) instead of the dense
    ``[T, n]`` emission planes, and cleans by label-row intersections.
    When a tree emits more than ``compact`` labels the budget
    overflows (``compact_overflow``) and the superstep is completed by
    the dense broadcast instead, as the reference's policy redoes it;
    stage A's constructions, which depend only on the tables before the
    superstep, are reused for that.
    """
    q = mesh.q

    def step(tables: Sequence[LabelTable], hc: Sequence[LabelTable],
             graph: Sequence[NodeGraph], roots: np.ndarray,
             valid: np.ndarray) -> SuperstepOut:
        roots = np.asarray(roots)
        valid = np.asarray(valid) & (roots >= 0)
        T = roots.shape[1]
        if T % batch:
            raise ValueError(f"superstep width {T} is not a multiple of "
                             f"the batch {batch}")
        # ---- stage A: every node constructs its trees ----------------
        roots_d, emits, dists, works, explored = [], [], [], [], []
        for i, dev in enumerate(mesh.devices):
            G = graph[i]
            r = torch.as_tensor(np.where(roots[i] >= 0, roots[i], 0)
                                .astype(np.int64), device=dev)
            v = torch.as_tensor(valid[i], device=dev)
            work = None if plant_trees else _clone(tables[i])
            # DGLL's local table: the common labels, or an empty one
            loc = hc[i] if use_hc else (None if plant_trees
                                        else lbl.empty(n, 1, dev))
            em, ds = [], []
            exp = torch.zeros((), dtype=torch.int32, device=dev)
            for s in range(0, T, batch):
                rb, vb = r[s:s + batch], v[s:s + batch]
                if not valid[i, s:s + batch].any():
                    # an all-padding batch emits nothing and its
                    # distances are never read
                    em.append(torch.zeros((batch, n), dtype=torch.bool,
                                          device=dev))
                    ds.append(torch.full((batch, n), torch.inf,
                                         dtype=torch.float32, device=dev))
                    continue
                if plant_trees:
                    tb = plant_batch(G.ell_src, G.ell_w, G.rank, rb, vb,
                                     hc=loc, use_hc=use_hc,
                                     layout=G.layout)
                    emit, dist, e = tb.emit, tb.dist, tb.explored
                else:
                    bl = construct_batch(G.ell_src, G.ell_w, G.rank, rb,
                                         vb, work, loc, rank_queries=True,
                                         layout=G.layout)
                    emit, dist = bl.emit, bl.dist
                    e = torch.isfinite(dist).sum(dim=-1, dtype=torch.int32)
                    # tentative insert so later batches can prune
                    lbl.insert_batch(work, rb, emit, dist)
                exp = exp + torch.where(vb, e, 0).sum(dtype=torch.int32)
                em.append(emit)
                ds.append(dist)
            roots_d.append(torch.as_tensor(roots[i], device=dev))
            emits.append(torch.cat(em))
            dists.append(torch.cat(ds))
            works.append(work)
            explored.append(exp)

        zero = [torch.zeros((), dtype=torch.bool, device=d)
                for d in mesh.devices]
        ovf_extra = zero
        if plant_trees:
            finals = emits                 # canonical by construction
        else:
            dense = compact <= 0
            if not dense:
                K = min(compact, n)
                keys = [torch.where(e, n - torch.arange(n, device=e.device),
                                    0) for e in emits]
                tops = [torch.topk(k, K, dim=1) for k in keys]
                ovf_extra = [(e.sum(dim=1) > (t.values > 0).sum(dim=1)).any()
                             for e, t in zip(emits, tops)]
                # the budget overflows on some node: complete densely
                dense = any(bool(x) for x in ovf_extra)
            if dense:
                finals = _dense_clean(mesh, n, T, works, graph, roots_d,
                                      emits, dists)
            else:
                finals = _compact_clean(mesh, n, T, works, graph, roots_d,
                                        emits, dists, tops)

        # ---- stage C: each node's final insert -----------------------
        new_tables, nls, ovfs = [], [], []
        for i in range(q):
            r = torch.where(roots_d[i] >= 0, roots_d[i], 0)
            t, ovf = lbl.insert_batch(tables[i], r, finals[i], dists[i])
            new_tables.append(t)
            nls.append(finals[i].sum(dtype=torch.int32))
            ovfs.append(ovf)
        return SuperstepOut(table=new_tables, new_labels=nls,
                            explored=explored, overflow=ovfs,
                            compact_overflow=ovf_extra)

    return step


def _dense_clean(mesh, n, T, works, graph, roots_d, emits, dists):
    """Broadcast the emission planes and run the distributed DQ_Clean
    (§5.1 sync): each node's best witness over its own partition, then
    `pmax`. Returns each node's surviving emissions ``[T, n]``."""
    q = mesh.q
    g_roots = coll.all_gather(roots_d)                     # [q, T]
    g_emit = coll.all_gather(emits)                        # [q, T, n]
    g_dist = coll.all_gather(dists)
    parts = []
    for i in range(q):
        fr = g_roots[i].reshape(q * T).long()
        fr = torch.where(fr >= 0, fr, 0)
        fe = g_emit[i].reshape(q * T, n)
        delta = torch.where(fe, g_dist[i].reshape(q * T, n), -torch.inf)
        hmap = lbl.hub_distance_map(works[i], fr)          # own hubs only
        parts.append(lbl.cover_best_rank(works[i], hmap, graph[i].rank,
                                         delta))
        del hmap, delta
    best = coll.pmax(parts)                                # bitvector Σ
    finals = []
    for i in range(q):
        fr = g_roots[i].reshape(q * T).long()
        fr = torch.where(fr >= 0, fr, 0)
        red = g_emit[i].reshape(q * T, n) & (
            best[i] > graph[i].rank[fr][:, None])
        finals.append(emits[i] & ~red.reshape(q, T, n)[i])
    return finals


def _compact_clean(mesh, n, T, works, graph, roots_d, emits, dists, tops):
    """§Perf-2: broadcast each tree's top-``K`` emitted ``(vertex,
    distance)`` pairs and clean by intersecting label rows on every
    node, then `pmax`. Returns each node's surviving emissions."""
    q = mesh.q
    ids_l, val_l, d_l = [], [], []
    for dist, t in zip(dists, tops):
        val = t.values > 0
        ids = torch.where(val, t.indices, 0)
        d = torch.where(val, torch.gather(dist, 1, ids), torch.inf)
        ids_l.append(ids)
        val_l.append(val)
        d_l.append(d)
    g_roots = coll.all_gather(roots_d)                     # [q, T]
    g_ids = coll.all_gather(ids_l)                         # [q, T, K]
    g_val = coll.all_gather(val_l)
    g_d = coll.all_gather(d_l)
    K = ids_l[0].shape[1]
    parts = []
    for i in range(q):
        fr = g_roots[i].long()
        fr = torch.where(fr >= 0, fr, 0).reshape(q * T)
        hmap = lbl.hub_distance_map(works[i], fr)          # [qT, n]
        part = _compact_part(works[i], hmap, graph[i].rank,
                             g_ids[i].reshape(q * T, K),
                             g_val[i].reshape(q * T, K),
                             g_d[i].reshape(q * T, K))
        parts.append(part.reshape(q, T, K))
        del hmap
    best = coll.pmax(parts)
    finals = []
    for i, dev in enumerate(mesh.devices):
        fr = g_roots[i].long()
        fr = torch.where(fr >= 0, fr, 0)
        red = g_val[i] & (best[i] > graph[i].rank[fr][..., None])
        mine = g_val[i][i] & red[i]                         # [T, K]
        tt = torch.arange(T, device=dev)[:, None].expand_as(mine)
        flat = (tt * n + g_ids[i][i])[mine]
        drop = torch.zeros(T * n, dtype=torch.bool, device=dev)
        drop[flat] = True
        finals.append(emits[i] & ~drop.view(T, n))
    return finals


def stack_partitions(parts: Sequence[LabelTable]) -> LabelTable:
    """The per-node partitions as one ``[q, n, L]`` table (the
    reference's global view) on node 0's device."""
    dev = parts[0].hubs.device
    return LabelTable(*(torch.stack([getattr(t, f).to(dev) for t in parts])
                        for f in ("hubs", "dist", "count")))


def merge_partitions(parts: Sequence[LabelTable]) -> LabelTable:
    """Collapse the per-node partitions into one ``[n, q*L]`` table on
    node 0's device: each row's node slots in node order, the valid
    ones first (a stable sort, as the reference's numpy merge)."""
    t = stack_partitions(parts)
    q, n, L = t.hubs.shape
    hubs = t.hubs.permute(1, 0, 2).reshape(n, q * L)
    dist = t.dist.permute(1, 0, 2).reshape(n, q * L)
    valid = hubs >= 0
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    return LabelTable(torch.gather(hubs, 1, order).contiguous(),
                      torch.gather(dist, 1, order).contiguous(),
                      valid.sum(dim=1, dtype=torch.int32))


def dgll_chl(g, rank: np.ndarray, *, mesh: Optional[NodeMesh] = None,
             batch: int = 4, beta: float = 8.0, first_superstep: int = 1,
             cap: Optional[int] = None, eta: int = 0, hc_cap: int = 32,
             compact: int = 0, **kw) -> Tuple[LabelTable, dict]:
    """Pure DGLL (optionally with an η-hub Common Label Table) on
    ``mesh`` (default: one node per card). Returns the *merged* label
    table and stats; the per-node partitions are
    ``stats["partitioned"]``."""
    from repro_torch.core.hybrid import run_distributed
    return run_distributed(g, rank, mesh=mesh, batch=batch, beta=beta,
                           first_superstep=first_superstep, cap=cap,
                           eta=eta, hc_cap=hc_cap, psi_threshold=0.0,
                           compact=compact, algo_name="dgll", **kw)

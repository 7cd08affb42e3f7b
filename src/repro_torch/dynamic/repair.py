"""Rank-respecting incremental repair: re-plant only affected trees.

The repair pass is another engine policy: a :class:`RepairPolicy` is a
:class:`~repro_torch.engine.policies.PlantPolicy` whose root schedule
is the *affected* hub set (rank order kept), run on the **mutated**
graph through the unmodified ``engine.run`` loop, on the index's
device, so it inherits batching, typed ``SuperstepRecord`` rows and
checkpoint/resume. The repaired store is then assembled on the host:

1. drop every old label whose hub is affected (those trees' emissions
   are stale; :mod:`repro_torch.dynamic.frontier` proves the rest are
   not);
2. append the re-planted emissions from the repair sink;
3. restore each row's canonical order with one stable argsort on
   ``order_index(hub)``.

Step 3 is what makes the result **bit-identical** to a from-scratch
rebuild: the engine schedule emits roots in ascending order index, so
a rebuilt row is exactly its label set sorted by ``order_index``; hubs
are unique per row, so the sort has no ties. Distances agree bitwise
because unaffected trees see identical shortest-path multisets in both
graphs and integral weights keep f32 path sums exact.

Checkpoint safety: ``RepairPolicy.kind == "repair"``; the engine
stamps the kind into every checkpoint and refuses to restore across
kinds, so a repair resume never adopts a build's label state.

A sharded store re-plants into a `StreamingShardSink` and merges shard
by shard (each shard's rows canonicalised the same way, at their tight
cap), so the result equals a sharded rebuild. A directed index is
refused, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import interop
from repro_torch.core.labels import LabelOverflowError
from repro_torch.engine.policies import PlantPolicy
from repro_torch.engine.records import SuperstepRecord
from repro_torch.engine.runner import run
from repro_torch.engine.scheduler import rank_order
from repro_torch.engine.sink import DenseSink, StreamingShardSink
from repro_torch.ft.inject import fault_site
from repro_torch.index.store import DenseStore, ShardedStore

from .frontier import affected_hubs
from .mutations import MutationBatch


class RepairPolicy(PlantPolicy):
    """PLaNT over the affected roots only, on the mutated graph.

    Inherits the plant step verbatim; only the schedule (the affected
    subset, rank order kept by the caller) and the checkpoint identity
    change. The inherited fingerprint already covers (mutated graph,
    hierarchy, affected order): the inputs the repair emissions
    depend on.
    """

    name = "repair"
    kind = "repair"


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """Typed outcome of one ``CHLIndex.apply`` wave."""

    wall_s: float
    mutations: Dict[str, int]        # insert/delete/reweight counts
    touched: int                     # mutated-edge endpoints
    affected: int                    # trees re-planted
    invalidated: int                 # old labels dropped
    repaired: int                    # labels re-emitted
    total_labels: int                # post-repair index size
    als: float
    cap: Optional[int]               # dense cap after repair (None: sharded)
    store: str                       # "dense" | "sharded"
    supersteps: List[SuperstepRecord] = dataclasses.field(
        default_factory=list)
    resumed_from: Optional[int] = None

    @property
    def waves(self) -> int:
        return len(self.supersteps)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RepairReport":
        d = dict(d)
        d["supersteps"] = [SuperstepRecord(**s)
                           for s in d.get("supersteps", [])]
        return cls(**d)

    def summary(self) -> str:
        m = self.mutations
        return (f"mutations={m.get('insert', 0)}i/{m.get('delete', 0)}d/"
                f"{m.get('reweight', 0)}r affected={self.affected} "
                f"invalidated={self.invalidated} "
                f"repaired={self.repaired} labels={self.total_labels} "
                f"ALS={self.als:.1f} waves={self.waves} "
                f"wall={self.wall_s:.2f}s")


def _order_index(rank: np.ndarray) -> np.ndarray:
    """i64 [n] position of each vertex in the engine's root schedule:
    the canonical per-row label sort key."""
    order = rank_order(rank)
    oi = np.empty(len(order), dtype=np.int64)
    oi[order] = np.arange(len(order), dtype=np.int64)
    return oi


def _canonical_rows(hubs: np.ndarray, dist: np.ndarray, oi: np.ndarray,
                    cap: Optional[int] = None):
    """Sort each row's valid labels into ascending order index (the
    order a from-scratch schedule inserts them), compact the invalid
    slots to the tail, and trim/pad to ``cap`` (default: the tight
    cap)."""
    valid = hubs >= 0
    key = np.where(valid, oi[np.where(valid, hubs, 0)],
                   np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind="stable")
    hubs = np.take_along_axis(hubs, order, axis=1)
    dist = np.take_along_axis(dist, order, axis=1)
    count = valid.sum(axis=1).astype(np.int32)
    tight = int(max(1, count.max())) if count.size else 1
    cap = tight if cap is None else int(cap)
    if cap < tight:
        raise ValueError(f"cap {cap} below tight row max {tight}")
    pad = cap - hubs.shape[1]
    if pad > 0:
        hubs = np.pad(hubs, ((0, 0), (0, pad)), constant_values=-1)
        dist = np.pad(dist, ((0, 0), (0, pad)), constant_values=np.inf)
    else:
        hubs = hubs[:, :cap]
        dist = dist[:, :cap]
    # dropped labels were blanked before the sort, so the tail is
    # already (-1, inf); enforce it anyway so padding is canonical
    tail = np.arange(cap)[None, :] >= count[:, None]
    hubs = np.where(tail, np.int32(-1), hubs).astype(np.int32)
    dist = np.where(tail, np.float32(np.inf), dist).astype(np.float32)
    return hubs, dist, count


def _drop_affected(hubs: np.ndarray, dist: np.ndarray,
                   affected_mask: np.ndarray):
    """Blank (-1/inf) every label slot owned by an affected hub;
    returns (hubs, dist, dropped count)."""
    hubs = hubs.copy()
    dist = dist.astype(np.float32, copy=True)
    stale = (hubs >= 0) & affected_mask[np.where(hubs >= 0, hubs, 0)]
    hubs[stale] = -1
    dist[stale] = np.inf
    return hubs, dist, int(stale.sum())


def repair_index(idx, batch: MutationBatch, g, *, ckpt=None,
                 resume: bool = False,
                 verbose: bool = False) -> RepairReport:
    """Repair ``idx`` (built on pre-mutation graph ``g``) in place so it
    indexes ``batch.apply(g)``, bit-identically to a from-scratch PLaNT
    rebuild; returns the :class:`RepairReport`. The frontier and the
    re-plant run on the store's device. ``ckpt``/``resume`` thread into
    ``engine.run`` under ``kind="repair"``."""
    if idx.directed:
        raise NotImplementedError(
            "apply() currently supports undirected indices")
    if idx.store.kind not in ("dense", "sharded"):
        raise NotImplementedError(
            f"apply() needs a writable dense or sharded store "
            f"(got {idx.store.kind!r}); reload with store='dense' or "
            "'sharded' (spill/compressed residency is read-only — "
            "re-home, repair, then save back compressed)")
    if g.n != idx.n:
        raise ValueError(f"graph has n={g.n} but the index has n={idx.n}")

    t0 = time.perf_counter()
    dev = idx.store.device
    rb = batch.resolve(g)
    g_new = batch.apply(g)
    affected = affected_hubs(g, g_new, rb, device=dev)
    oi = _order_index(idx.rank)
    affected_mask = np.zeros(idx.n, dtype=bool)
    affected_mask[affected] = True
    # rank order within the affected subset == ascending order index
    roots = affected[np.argsort(oi[affected], kind="stable")]
    if verbose:
        print(f"[repair] {len(batch)} mutations touch "
              f"{len(batch.touched())} vertices; {len(roots)} trees "
              f"affected")

    records: List[SuperstepRecord] = []
    resumed_from: Optional[int] = None
    rep_table = None
    repaired = 0
    sharded = idx.store.kind == "sharded"
    if len(roots) and sharded:
        policy = RepairPolicy(g_new, idx.rank, batch=idx.plan.batch,
                              device=dev, roots_order=roots)
        sink = StreamingShardSink(idx.n, idx.rank, idx.store.num_shards)
        res = run(policy, sink, ckpt=ckpt, resume=resume, verbose=verbose)
        records, resumed_from = res.records, res.resumed_from
        repaired = sink.total_labels
        rep_table = dict(sink.shard_arrays())
    elif len(roots):
        cap_r = idx.store.to_table().cap
        attempt = 0
        while True:
            policy = RepairPolicy(g_new, idx.rank, batch=idx.plan.batch,
                                  device=dev, roots_order=roots)
            try:
                res = run(policy, DenseSink(idx.n, cap_r, dev), ckpt=ckpt,
                          resume=(resume if attempt == 0
                                  else ckpt is not None),
                          verbose=verbose)
                break
            except LabelOverflowError:
                grown = min(max(cap_r + 1,
                                int(cap_r * idx.plan.cap_growth)), idx.n)
                if attempt >= idx.plan.max_cap_retries or grown == cap_r:
                    raise
                if verbose:
                    print(f"[repair] emission overflow at cap={cap_r}; "
                          f"regrowing to {grown}")
                cap_r = grown
                attempt += 1
        records, resumed_from = res.records, res.resumed_from
        rep_table = res.sink.table()
        repaired = int(rep_table.count.sum())

    # the point of no return for the in-memory store: past here the
    # merge swaps idx.store; before here a crash leaves the index
    # untouched (the on-disk artifact is untouched either way: only an
    # explicit save() publishes the merge)
    fault_site("repair.merge")
    invalidated = 0
    if sharded:
        merged = []
        for k, arrs in idx.store.shard_arrays():
            hubs, dist, dropped = _drop_affected(arrs["hubs"], arrs["dist"],
                                                 affected_mask)
            invalidated += dropped
            if rep_table is not None:
                hubs = np.concatenate([hubs, rep_table[k]["hubs"]], axis=1)
                dist = np.concatenate([dist, rep_table[k]["dist"]], axis=1)
            h, d, c = _canonical_rows(hubs, dist, oi)
            merged.append({"hubs": h, "dist": d, "count": c})
        idx.store = ShardedStore.from_shard_arrays(merged, device=dev)
        new_cap = None
    else:
        old = idx.store.to_table()
        hubs, dist, invalidated = _drop_affected(
            old.hubs.cpu().numpy(), old.dist.cpu().numpy(), affected_mask)
        if rep_table is not None:
            hubs = np.concatenate([hubs, rep_table.hubs.cpu().numpy()],
                                  axis=1)
            dist = np.concatenate([dist, rep_table.dist.cpu().numpy()],
                                  axis=1)
        counts = (hubs >= 0).sum(axis=1)
        tight = int(max(1, counts.max())) if counts.size else 1
        # keep the old cap when the repaired rows still fit (padding
        # then equals a rebuild's at the same cap); grow like `build`
        # otherwise
        new_cap = old.cap
        while new_cap < tight:
            new_cap = min(max(new_cap + 1,
                              int(new_cap * idx.plan.cap_growth)), idx.n)
        h, d, c = _canonical_rows(hubs, dist, oi, new_cap)
        idx.store = DenseStore(interop.label_table(h, d, c, dev))
    # any construction-time partitioned view predates the mutation
    idx.partitioned = None

    total = idx.store.total_labels
    return RepairReport(
        wall_s=time.perf_counter() - t0,
        mutations=batch.counts,
        touched=int(len(batch.touched())),
        affected=int(len(roots)),
        invalidated=invalidated,
        repaired=repaired,
        total_labels=int(total),
        als=total / max(1, idx.n),
        cap=new_cap,
        store=idx.store.kind,
        supersteps=records,
        resumed_from=resumed_from)

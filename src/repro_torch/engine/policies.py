"""Construction policies — each algorithm as a thin plug into the engine.

A policy is what is left of a construction algorithm once the engine
owns the loop: the per-batch device step, the emission filter and any
phase rule (GLL's alpha-threshold flush). The checkpoint hooks
(``kind``, ``fingerprint``, ``config``, ``meta``/``load_meta``,
``counters``/``load_counters``) are what ``engine.run`` stamps into a
checkpoint and checks before it resumes from one.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import labels as lbl
from repro_torch.core.gll import BatchLabels, clean_superstep, construct_batch
from repro_torch.core.plant import plant_batch
from repro_torch.engine.records import (SuperstepRecord, make_record,
                                        pack_stats)
from repro_torch.engine.scheduler import BatchSchedule, Step, rank_order
from repro_torch.graphs.graph import device_arrays
from repro_torch.sssp.relax import ell_layout


class StepOutcome(NamedTuple):
    """What a policy hands back when a superstep commits: a packed
    device ``stats`` row (fetched after the loop, or at the commit for
    an ``eager_stats`` policy) or a ready host ``record``; exactly one
    of the two is set."""

    mode: str
    stats: Optional[torch.Tensor] = None
    record: Optional[SuperstepRecord] = None
    trees: Optional[int] = None


def build_fingerprint(g, rank: np.ndarray) -> str:
    """Stable fingerprint of (graph, hierarchy), as the reference
    computes it, plus the hub tail of a degree-capped graph (a graph
    with none fingerprints as in the reference): engine checkpoints
    carry it, so that a resume never adopts labels committed for
    another build."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(
        np.asarray(rank).astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(g.ell_src).astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(g.ell_w).astype(np.float64)).tobytes())
    if g.tail_arcs:
        for a, dtype in ((g.tail_dst, np.int64), (g.tail_src, np.int64),
                         (g.tail_w, np.float64)):
            h.update(np.ascontiguousarray(
                np.asarray(a).astype(dtype)).tobytes())
    return h.hexdigest()


class Policy:
    """Interface the engine drives. Subclasses override what they use."""

    name: str = "?"
    #: checkpoint-compatibility class: construction policies are
    #: "build", incremental repair is "repair"; a checkpoint written
    #: under one kind is never adopted by the other
    kind: str = "build"
    #: True: the engine reads stats (and checks overflow) at every
    #: commit; False: one batched fetch after the loop
    eager_stats: bool = False

    @functools.cached_property
    def fingerprint(self) -> Optional[str]:
        """sha256 of the build input, (graph, rank) and whatever else
        changes the labels; computed when first read, since only
        checkpoints read it and hashing a road-size adjacency takes
        seconds."""
        return None

    def config(self) -> dict:
        """Schedule-shaping knobs (batch grouping changes committed
        boundaries and, for optimistic algorithms, the labels)."""
        return {}

    def schedule(self):
        raise NotImplementedError

    def begin(self, start_pos: int, resumed: bool) -> None:
        """Called once before the loop (after any resume restore)."""

    def prologue(self, sink) -> Optional[Tuple[StepOutcome, int]]:
        """Optional pre-loop phase consuming roots; returns (outcome,
        new root cursor). Only called on fresh (non-resumed) runs."""
        return None

    def step(self, st: Step, sink) -> Optional[StepOutcome]:
        """Process one scheduled step; ``None`` = buffered, no commit."""
        raise NotImplementedError

    def epilogue(self, sink) -> Optional[StepOutcome]:
        """Commit any buffered tail work (GLL's final flush)."""
        return None

    def observe(self, record: SuperstepRecord) -> None:
        """Committed-record hook."""

    # ------------------------------------------------ checkpoint bits

    def meta(self) -> dict:
        return {}

    def load_meta(self, meta: dict) -> None:
        del meta

    def counters(self) -> Dict[str, int]:
        return {}

    def load_counters(self, counters: Dict[str, int]) -> None:
        del counters

    def extras(self, sink) -> dict:
        return {}


class PlantPolicy(Policy):
    """PLaNT (§5.2): unpruned max-rank-ancestor trees, zero cross-tree
    dependence — emissions are canonical on arrival."""

    name = "plant"

    def __init__(self, g, rank: np.ndarray, *, batch: int, device,
                 hc: Optional[lbl.LabelTable] = None,
                 roots_order: Optional[np.ndarray] = None):
        self.g, self.rank = g, rank
        self.batch = int(batch)
        self.custom_order = roots_order is not None
        self.order = (np.asarray(roots_order) if self.custom_order
                      else rank_order(rank))
        self.arrays = device_arrays(g, rank, device)
        self.device = self.arrays.ell_src.device
        # the Common Label Table, when given, prunes every tree (§5.3)
        self.hc = (None if hc is None else
                   lbl.LabelTable(*(x.to(self.device) for x in hc)))
        # the source-bucketed layout (None when one window covers the
        # graph), built once per graph rather than per batch
        self.layout = ell_layout(self.arrays.ell_src, self.arrays.ell_w,
                                 batch=self.batch, tail=self.arrays.tail)

    @functools.cached_property
    def fingerprint(self) -> str:
        fp = build_fingerprint(self.g, self.rank)
        # a custom root order or a Common Label Table changes which
        # labels each superstep emits: both join the fingerprint
        if self.custom_order:
            fp += ":" + hashlib.sha256(np.ascontiguousarray(
                self.order.astype(np.int64)).tobytes()).hexdigest()
        if self.hc is not None:
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(
                self.hc.hubs.cpu().numpy().astype(np.int64)).tobytes())
            h.update(np.ascontiguousarray(
                self.hc.dist.cpu().numpy().astype(np.float64)).tobytes())
            fp += ":hc:" + h.hexdigest()
        return fp

    def config(self) -> dict:
        return {"batch": self.batch, "use_hc": self.hc is not None}

    def schedule(self) -> BatchSchedule:
        return BatchSchedule(self.order, self.batch)

    def step(self, st: Step, sink) -> StepOutcome:
        a, dev = self.arrays, self.device
        # spans while a profiler runs (`repro_torch.tracing`)
        with tracing.span("plant.step", dev, pos=st.pos):
            with tracing.span("plant.roots_h2d", dev):
                roots_d = torch.as_tensor(st.roots, device=dev)
                valid_d = torch.as_tensor(st.valid, device=dev)
            tb = plant_batch(a.ell_src, a.ell_w, a.rank, roots_d, valid_d,
                             hc=self.hc, use_hc=self.hc is not None,
                             layout=self.layout)
            sink.insert(roots_d, tb.emit, tb.dist)
            with tracing.span("plant.stats", dev):
                stats = pack_stats(
                    tb.emit.sum(dtype=torch.int32),
                    (tb.explored * valid_d).sum(dtype=torch.int32),
                    tb.sweeps, device=dev)
        return StepOutcome(mode=self.name, stats=stats,
                           trees=int(st.valid.sum()))


class DirectedPlantPolicy(Policy):
    """Paper footnote 1's digraph labeling: per batch, one PLaNTed tree
    on G (``d(h->v)``, into ``"in"``) and one on its reverse
    (``d(v->h)``, into ``"out"``), each sweeping with its own layout."""

    name = "directed"

    def __init__(self, g, rank: np.ndarray, *, batch: int, device):
        if not g.directed:
            raise ValueError("DirectedPlantPolicy needs a directed graph")
        self.g, self.rank = g, rank
        self.batch = int(batch)
        self.order = rank_order(rank)
        self.fwd = device_arrays(g, rank, device)
        self.device = self.fwd.ell_src.device
        self.bwd = device_arrays(g.reverse(), rank, self.device)
        self.fwd_layout = ell_layout(self.fwd.ell_src, self.fwd.ell_w,
                                     batch=self.batch, tail=self.fwd.tail)
        self.bwd_layout = ell_layout(self.bwd.ell_src, self.bwd.ell_w,
                                     batch=self.batch, tail=self.bwd.tail)

    @functools.cached_property
    def fingerprint(self) -> str:
        return build_fingerprint(self.g, self.rank)

    def config(self) -> dict:
        return {"batch": self.batch}

    def schedule(self) -> BatchSchedule:
        return BatchSchedule(self.order, self.batch)

    def step(self, st: Step, sink) -> StepOutcome:
        r = torch.as_tensor(st.roots, device=self.device)
        v = torch.as_tensor(st.valid, device=self.device)
        f, b = self.fwd, self.bwd
        tb_f = plant_batch(f.ell_src, f.ell_w, f.rank, r, v,
                           layout=self.fwd_layout)
        sink.insert(r, tb_f.emit, tb_f.dist, channel="in")
        tb_b = plant_batch(b.ell_src, b.ell_w, b.rank, r, v,
                           layout=self.bwd_layout)
        sink.insert(r, tb_b.emit, tb_b.dist, channel="out")
        stats = pack_stats(
            tb_f.emit.sum(dtype=torch.int32)
            + tb_b.emit.sum(dtype=torch.int32),
            ((tb_f.explored + tb_b.explored) * v).sum(dtype=torch.int32),
            max(tb_f.sweeps, tb_b.sweeps), device=self.device)
        return StepOutcome(mode=self.name, stats=stats,
                           trees=int(st.valid.sum()))


class GLLPolicy(Policy):
    """Optimistic construction + interleaved DQ_Clean (§4).

    A superstep is one alpha-threshold flush: batches accumulate
    optimistic emissions in a local table; when the local label count
    reaches ``alpha * n`` (never, for LCC and paraPLL: ``alpha=None``)
    the pending emissions are cleaned against global and local and
    committed to the sink, whose table is the global table the
    distance queries consult.
    """

    eager_stats = True          # the alpha-threshold decision is host-side

    def __init__(self, g, rank: np.ndarray, *, batch: int, cap: int, device,
                 alpha: Optional[float] = 4.0, rank_queries: bool = True,
                 clean: bool = True, plant_first_superstep: bool = False,
                 mode_name: str = "gll"):
        self.name = mode_name
        self.g, self.rank = g, rank
        self.n = g.n
        self.cap = int(cap)
        self.batch = int(batch)
        self.order = rank_order(rank)
        self.arrays = device_arrays(g, rank, device)
        self.device = self.arrays.ell_src.device
        self.layout = ell_layout(self.arrays.ell_src, self.arrays.ell_w,
                                 batch=self.batch, tail=self.arrays.tail)
        self.alpha = alpha
        self.rank_queries = rank_queries
        self.clean = clean
        self.plant_first = plant_first_superstep
        self.threshold = np.inf if alpha is None else float(alpha) * self.n
        self.loc = lbl.empty(self.n, self.cap, self.device)
        self.pending: List[BatchLabels] = []
        self.local_labels = 0
        self._trees_pending = 0
        self._first = True
        self._cleaned = 0
        self._constructed = 0

    @functools.cached_property
    def fingerprint(self) -> str:
        return build_fingerprint(self.g, self.rank)

    def config(self) -> dict:
        return {"batch": self.batch,
                "alpha": None if self.alpha is None else float(self.alpha),
                "rank_queries": self.rank_queries, "clean": self.clean,
                "plant_first": self.plant_first}

    def schedule(self) -> BatchSchedule:
        return BatchSchedule(self.order, self.batch)

    def begin(self, start_pos: int, resumed: bool) -> None:
        # a resumed run re-enters at a flush boundary: the local table
        # and the pending buffer start empty, and the PLaNTed first
        # superstep (if any) is already committed
        self._first = start_pos == 0

    def step(self, st: Step, sink) -> Optional[StepOutcome]:
        a = self.arrays
        roots_d = torch.as_tensor(st.roots, device=self.device)
        valid_d = torch.as_tensor(st.valid, device=self.device)
        if self._first and self.plant_first:
            tb = plant_batch(a.ell_src, a.ell_w, a.rank, roots_d, valid_d,
                             layout=self.layout)
            bl = BatchLabels(roots=roots_d, emit=tb.emit, dist=tb.dist)
        else:
            bl = construct_batch(a.ell_src, a.ell_w, a.rank, roots_d,
                                 valid_d, sink.table(), self.loc,
                                 rank_queries=self.rank_queries,
                                 layout=self.layout)
        self._first = False
        self.loc, ovf = lbl.insert_batch(self.loc, roots_d, bl.emit, bl.dist)
        sink.note_overflow(ovf)
        self.pending.append(bl)
        self._trees_pending += int(bl.roots.shape[0])
        nl = int(bl.emit.sum())
        self.local_labels += nl
        self._constructed += nl
        if self.local_labels >= self.threshold:
            return self._flush(sink)
        return None

    def epilogue(self, sink) -> Optional[StepOutcome]:
        return self._flush(sink)

    def _flush(self, sink) -> Optional[StepOutcome]:
        if not self.pending:
            return None
        roots = torch.cat([b.roots for b in self.pending])
        emit = torch.cat([b.emit for b in self.pending])
        dist = torch.cat([b.dist for b in self.pending])
        if self.clean:
            red = clean_superstep(sink.table(), self.loc, self.arrays.rank,
                                  roots, emit, dist)
            self._cleaned += int(red.sum())
            emit = emit & ~red
        sink.insert(roots, emit, dist)
        committed = int(emit.sum())
        trees = self._trees_pending
        # the local table starts the next superstep empty (in place)
        self.loc.hubs.fill_(-1)
        self.loc.dist.fill_(torch.inf)
        self.loc.count.zero_()
        self.pending = []
        self.local_labels = 0
        self._trees_pending = 0
        return StepOutcome(
            mode=self.name, trees=trees,
            record=make_record(self.name, labels=committed, trees=trees))

    def counters(self) -> Dict[str, int]:
        return {"cleaned": self._cleaned, "constructed": self._constructed}

    def load_counters(self, counters: Dict[str, int]) -> None:
        self._cleaned = int(counters.get("cleaned", 0))
        self._constructed = int(counters.get("constructed", 0))


class PLLRefPolicy(Policy):
    """Sequential PLL (the host oracle) driven through the engine: the
    exact CHL is computed once, then its emissions replay through the
    sink in rank order, batch by batch."""

    name = "pll-ref"

    def __init__(self, g, rank: np.ndarray, *, batch: int, device):
        self.g = g
        self.n = g.n
        self.batch = int(batch)
        self.rank = np.asarray(rank)
        self.order = rank_order(rank)
        self.device = device
        self._by_hub: Dict[int, List[Tuple[int, float]]] = {}

    @functools.cached_property
    def fingerprint(self) -> str:
        return build_fingerprint(self.g, self.rank)

    def config(self) -> dict:
        return {"batch": self.batch}

    def schedule(self) -> BatchSchedule:
        return BatchSchedule(self.order, self.batch)

    def begin(self, start_pos: int, resumed: bool) -> None:
        from repro_torch.core.pll import pll_undirected
        by_hub: Dict[int, List[Tuple[int, float]]] = {}
        for v, row in enumerate(pll_undirected(self.g, self.rank)):
            for h, d in row.items():
                by_hub.setdefault(int(h), []).append((v, float(d)))
        self._by_hub = by_hub

    def step(self, st: Step, sink) -> StepOutcome:
        B = len(st.roots)
        emit = np.zeros((B, self.n), dtype=bool)
        dd = np.full((B, self.n), np.inf, dtype=np.float32)
        for b in range(B):
            if not st.valid[b]:
                continue
            for v, d in self._by_hub.get(int(st.roots[b]), ()):
                emit[b, v] = True
                dd[b, v] = d
        sink.insert(torch.as_tensor(st.roots, device=self.device),
                    torch.as_tensor(emit, device=self.device),
                    torch.as_tensor(dd, device=self.device))
        trees = int(st.valid.sum())
        return StepOutcome(
            mode=self.name, trees=trees,
            record=make_record(self.name, labels=int(emit.sum()),
                               trees=trees))

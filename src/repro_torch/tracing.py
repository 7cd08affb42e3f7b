"""Spans and counters of the build path, recorded while a profiler runs.

The recorder is on exactly while a ``torch.profiler`` session is open
(whatever its activities) and does nothing otherwise: there is no flag,
environment variable or config key. Off, each site costs one check of
the profiler's state: no allocation, no event, no device op.

How to read it::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing

    with profile(activities=[ProfilerActivity.CUDA]):
        ...                          # e.g. PlantPolicy.step, batch by batch
    snap = tracing.snapshot()        # plain host data; nothing is written
    tracing.reset()

`snapshot` returns a dict of three lists:

- ``spans``: one dict a span, in the order they opened: ``name``,
  ``t0_ns`` / ``t1_ns`` (host, ``time.perf_counter_ns``, the clock of
  ``chlbench/trace.py``'s spans, whose marker kernel ties it to the
  device clock), ``parent`` (index of the enclosing span, or None),
  ``batch`` (a running number each ``plant.step`` span opens; its
  children inherit it) with ``pos`` (the step's ``Step.pos``) beside
  it, and ``device_ms`` (CUDA: from a pair of timing events recorded on
  the current stream at the span's ends; None on the CPU);
- ``sweeps``: one dict a relaxation sweep (`sssp.relax`): ``call`` (a
  running number of recorded fixpoint calls) and ``sweep`` (its index
  in the call), ``parent``, ``batch``, ``pos``, ``device_ms`` (events
  around the sweep's gating ops, kernel and frontier compare), and the
  exact counts of the sweep's ``active`` set (the vertices whose state
  changed last sweep, plus those that just unblocked): ``trees_alive``
  (trees with a nonempty set), ``active_pairs`` (its (tree, vertex)
  pairs), ``active_edges`` (the sum of those sources' finite
  out-degrees: the (tree, edge) folds that can change a value), and
  ``edges`` (the adjacency's finite arcs: its layout's segments, the
  hub tail's included, or with no layout its ELL's);
  the layout's counters (`kernels.ell_relax.layout.BucketedEll.counters`):
  ``tail_arcs`` and ``split_rows`` (the hub tail's arcs and
  destinations), ``block_tiles`` and ``block_tile_edges`` (the tiles of
  one segment past the layout's cut, ``layout.block_cut``, and their
  edges: every sweep folds each such tile with its whole block, so
  these counts are that fold's engagement, and ``gated_windows`` below
  says where it read the mask first), ``lone_tiles`` and
  ``lone_tile_edges`` (those of them longer than the windowed kernel
  stages, which the block reads from device memory) and
  ``longest_segment`` (with no layout, the adjacency has no tail, since
  a tailed one always sweeps through its layout: 0 tail arcs, no block
  tile, and ``longest_segment`` None); where the windowed kernel
  packed its activity mask (`kernels.ell_relax.windowed.mask_pays`):
  ``mask_bits`` (the set bits: (live tree, source) pairs whose prop is
  finite), ``gated_windows`` (the (window, tree group) pairs that took
  the gated fold) and ``windows`` (all such pairs); None where no mask
  was packed (the CPU's plain sweeps, the dense kernel, a layout where
  the mask does not pay);
- ``checks``: the ``relax.check`` spans, one a fixpoint check, whose
  ``device_ms`` is the stream's gap from just before the ``any``
  reduction to just before the loop's next op: the reduction, the
  one-word read and the time the stream sat empty.

Span sites: ``plant.step`` with children ``plant.roots_h2d``,
``plant.relax``, ``plant.emit``, ``sink.insert`` and ``plant.stats``
(`engine.PlantPolicy.step`, `core.plant.plant_batch`,
`engine.DenseSink.insert`); ``relax.check`` inside ``plant.relax``.

No span is a ``torch.profiler.record_function`` or an NVTX range: a
range the profiler projects onto the device timeline would read as
device work in a trace of the same window. Events are resolved and
counters fetched (in one transfer) only when `snapshot` is called, so
recording never synchronises the stream. What recording adds to the
device: a masked sum over each sweep's active plane (`SweepRows`), on
the windowed route one copy of the kernel's per-window counts
(`window_stats`), and once per adjacency a count of its out-degrees, on
its first recorded sweep.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

#: adjacencies whose out-degrees are kept (as the sweep layouts are)
_DEGREE_CACHE_MAX = 4
#: sweeps a device buffer of per-sweep counts holds
_CHUNK = 64
#: one active pair in a sweep's packed count (`SweepRows`)
_PAIR = 1 << 32
#: a sweep's activity-mask fields, None where no mask was packed
_MASK_FIELDS = ("mask_bits", "gated_windows", "windows")
_NO_MASK = (None, None, None)
#: the layout counters of a sweep that runs no layout (and so no tail)
_NO_LAYOUT = {"tail_arcs": 0, "split_rows": 0, "block_tiles": 0,
              "block_tile_edges": 0, "lone_tiles": 0,
              "lone_tile_edges": 0, "longest_segment": None}


def active() -> bool:
    """True while a ``torch.profiler`` session is open."""
    return _profiler._is_profiler_enabled


def _event_pair(device) -> Optional[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]:
    """A pair of timing events on CUDA, the first recorded now on the
    device's current stream; None elsewhere."""
    if device is None or torch.device(device).type != "cuda":
        return None
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record(torch.cuda.current_stream(device))
    return pair


def _close_pair(pair, device) -> None:
    if pair is not None:
        pair[1].record(torch.cuda.current_stream(device))


def _elapsed_ms(pair) -> float:
    pair[1].synchronize()
    return pair[0].elapsed_time(pair[1])


class _Null:
    """The span handed out while recording is off: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "name", "device", "pos", "batch", "parent", "t0",
                 "t1", "events", "device_ms")

    def __init__(self, rec: "Recorder", name: str, device, pos):
        self.rec, self.name, self.device, self.pos = rec, name, device, pos
        self.batch = self.parent = self.t1 = self.events = None
        self.device_ms = None

    def __enter__(self):
        rec = self.rec
        self.parent = rec._stack[-1] if rec._stack else None
        if self.pos is not None:
            self.batch = rec._batches
            rec._batches += 1
        elif self.parent is not None:
            up = rec._spans[self.parent]
            self.batch, self.pos = up.batch, up.pos
        rec._stack.append(len(rec._spans))
        rec._spans.append(self)
        self.t0 = time.perf_counter_ns()
        self.events = _event_pair(self.device)
        return self

    def __exit__(self, *exc):
        _close_pair(self.events, self.device)
        self.t1 = time.perf_counter_ns()
        self.rec._stack.pop()
        return False


class SweepRows:
    """The per-sweep rows of one fixpoint call (`sssp.relax`): `open`
    before a sweep's first op, `close` after its frontier compare.

    A sweep's counts are one masked sum per tree over its active set,
    written into a device buffer that `Recorder.snapshot` reads: each
    active source adds ``2**32 + out-degree``, so the sum holds the
    tree's active pairs above bit 32 and their out-edges below."""

    __slots__ = ("rec", "device", "packed", "edges", "counters", "call",
                 "parent", "batch", "pos", "sweeps", "events", "chunks",
                 "device_ms", "counts", "mask_chunks", "masks")

    def __init__(self, rec: "Recorder", device, packed: torch.Tensor,
                 edges: int, counters: dict):
        self.rec = rec
        self.device, self.packed, self.edges = device, packed, edges
        self.counters = counters
        self.call = len(rec._sweep_calls)
        self.parent = rec._stack[-1] if rec._stack else None
        up = rec._spans[self.parent] if self.parent is not None else None
        self.batch, self.pos = (up.batch, up.pos) if up else (None, None)
        self.sweeps = 0
        self.events: List[tuple] = []
        self.chunks: List[torch.Tensor] = []    # i64 [_CHUNK, B]
        self.device_ms: List[Optional[float]] = []
        self.counts: Optional[List[tuple]] = None
        self.mask_chunks: List[torch.Tensor] = []   # i64 [_CHUNK, 2 w]
        self.masks: List[Optional[tuple]] = []

    def open(self) -> None:
        self.events.append(_event_pair(self.device))
        self.rec._open = self

    def window_stats(self, stats: torch.Tensor) -> None:
        """The open sweep's mask counts: ``stats`` i32 [2, windows,
        groups] (set bits, then 1 where the fold was gated), copied into
        a device buffer; rows no sweep wrote read -1."""
        k, i = divmod(self.sweeps, _CHUNK)
        if len(self.mask_chunks) <= k:
            self.mask_chunks.append(torch.full(
                (_CHUNK, stats.numel()), -1, dtype=torch.int64,
                device=stats.device))
        self.mask_chunks[k][i].copy_(stats.view(-1))

    def close(self, active: torch.Tensor) -> None:
        """``active``: bool [B, n], the sweep's propagating set."""
        self.rec._open = None
        _close_pair(self.events[-1], self.device)
        i = self.sweeps % _CHUNK
        if i == 0:
            self.chunks.append(torch.empty(
                (_CHUNK, active.shape[0]), dtype=torch.int64,
                device=active.device))
        torch.sum(torch.where(active, self.packed, 0), dim=1,
                  out=self.chunks[-1][i])
        self.sweeps += 1


class Recorder:
    """Spans, per-sweep rows and out-degree counts of one process."""

    def __init__(self):
        self._degrees: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.reset()

    def reset(self) -> None:
        """Drop everything recorded (and the cached out-degrees)."""
        self._spans: List[_Span] = []
        self._stack: List[int] = []
        self._sweep_calls: List[SweepRows] = []
        self._open: Optional[SweepRows] = None
        self._batches = 0
        self._degrees.clear()

    def span(self, name: str, device=None, pos: Optional[int] = None):
        """A span named ``name``; ``pos`` (a step's root cursor) opens a
        new batch. Events are recorded when ``device`` is a CUDA device.
        A no-op object while no profiler runs."""
        if not _profiler._is_profiler_enabled:
            return _NULL
        return _Span(self, name, device, pos)

    def sweep_rows(self, ell_src: torch.Tensor, ell_w: torch.Tensor,
                   layout=None) -> Optional[SweepRows]:
        """Rows for one fixpoint call over this adjacency (``layout``:
        its windowed `BucketedEll`, or None); None while no profiler
        runs."""
        if not _profiler._is_profiler_enabled:
            return None
        packed, edges = self._out_degree(ell_src, ell_w, layout)
        counters = _NO_LAYOUT if layout is None else layout.counters
        rows = SweepRows(self, ell_src.device, packed, edges, counters)
        self._sweep_calls.append(rows)
        return rows

    def window_stats(self, stats: torch.Tensor) -> None:
        """Hand the windowed kernel's per-window mask counts (i32 [2,
        windows, groups]) to the sweep row that is open; nothing while
        none is (no profiler, or a sweep outside `sssp.relax`)."""
        if self._open is not None:
            self._open.window_stats(stats)

    def _out_degree(self, ell_src, ell_w, layout) -> Tuple[torch.Tensor,
                                                          int]:
        """i64 [n] ``2**32 + finite out-degree`` (the term `SweepRows`
        sums) and the finite arc count, counted once per adjacency from
        the sources of its finite in-edges: the layout's segments (the
        hub tail's included) or, with no layout, the ELL's."""
        key = (id(ell_src), id(ell_w))
        hit = self._degrees.get(key)
        if hit is not None:
            ref_s, ref_w, packed, edges = hit
            if ref_s() is ell_src and ref_w() is ell_w:
                self._degrees.move_to_end(key)
                return packed, edges
            del self._degrees[key]              # id reused by a new tensor
        src = (ell_src[torch.isfinite(ell_w)] if layout is None
               else layout.segments.edge_src)
        edges = int(src.shape[0])
        if edges >= _PAIR:
            raise ValueError(f"tracing: {edges} arcs do not fit the low "
                             "32 bits of a sweep's packed count")
        packed = torch.bincount(src, minlength=ell_src.shape[0]) + _PAIR
        self._degrees[key] = (weakref.ref(ell_src), weakref.ref(ell_w),
                              packed, edges)
        while len(self._degrees) > _DEGREE_CACHE_MAX:
            self._degrees.popitem(last=False)
        return packed, edges

    def _resolve(self) -> None:
        for s in self._spans:
            if s.events is not None and s.t1 is not None:
                s.device_ms, s.events = _elapsed_ms(s.events), None
        by_device = OrderedDict()
        for c in self._sweep_calls:
            done = len(c.device_ms)
            c.device_ms += [None if e is None else _elapsed_ms(e)
                            for e in c.events[done:c.sweeps]]
            c.events[done:c.sweeps] = [None] * (c.sweeps - done)
            if c.counts is None or len(c.counts) < c.sweeps:
                c.counts = []
                if c.sweeps:
                    by_device.setdefault(c.device, []).append(c)
        for calls in by_device.values():        # one fetch a device
            flat = torch.cat([x.flatten() for c in calls
                              for x in c.chunks + c.mask_chunks]).tolist()
            at = 0
            for c in calls:
                B = c.chunks[0].shape[1]
                for i in range(c.sweeps):
                    row = flat[at + B * i:at + B * (i + 1)]
                    c.counts.append((sum(x > 0 for x in row),
                                     sum(x >> 32 for x in row),
                                     sum(x & (_PAIR - 1) for x in row)))
                at += B * _CHUNK * len(c.chunks)
                c.masks = [None] * c.sweeps
                if c.mask_chunks:
                    w = c.mask_chunks[0].shape[1]
                    for i in range(c.sweeps):
                        row = flat[at + w * i:at + w * (i + 1)]
                        if row[0] >= 0:
                            c.masks[i] = (sum(row[:w // 2]),
                                          sum(row[w // 2:]), w // 2)
                    at += w * _CHUNK * len(c.mask_chunks)

    def snapshot(self) -> dict:
        """Everything recorded so far as plain host data (module
        docstring); resolving events and fetching counters on first
        read. Calling it again returns the same data."""
        self._resolve()

        def span_dict(s):
            return {"name": s.name, "t0_ns": s.t0, "t1_ns": s.t1,
                    "parent": s.parent, "batch": s.batch, "pos": s.pos,
                    "device_ms": s.device_ms}

        spans = [span_dict(s) for s in self._spans]
        sweeps = [{"call": c.call, "sweep": i, "parent": c.parent,
                   "batch": c.batch, "pos": c.pos,
                   "device_ms": c.device_ms[i], "trees_alive": alive,
                   "active_pairs": pairs, "active_edges": edges,
                   "edges": c.edges, **c.counters,
                   **dict(zip(_MASK_FIELDS, c.masks[i] or _NO_MASK))}
                  for c in self._sweep_calls
                  for i, (alive, pairs, edges) in enumerate(c.counts)]
        return {"spans": spans, "sweeps": sweeps,
                "checks": [s for s in spans if s["name"] == "relax.check"]}


#: the process's recorder (a profiler session is process-wide too)
RECORDER = Recorder()
span = RECORDER.span
sweep_rows = RECORDER.sweep_rows
snapshot = RECORDER.snapshot
reset = RECORDER.reset
window_stats = RECORDER.window_stats

__all__ = ["RECORDER", "Recorder", "SweepRows", "active", "reset",
           "snapshot", "span", "sweep_rows", "window_stats"]

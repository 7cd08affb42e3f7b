"""Source-windowed ELL layout and its window plan.

The relaxation sweep gathers ``prop[b, src]`` and ``mrank[b, src]`` at
every in-edge source. Once the two ``[B, n]`` source planes (f32 + i32,
``8 · B · n`` bytes) outgrow the card's L2, gathers from sources spread
over all n miss to device memory. Source windowing cuts the planes into
``window``-wide slices that each fit half the L2, and groups every
vertex's in-edges by the window their source falls in, so a pass over
one window's edges gathers from an L2-resident slice.

The plan is balanced as in the reference package: ``num_windows =
ceil(n / cap)`` and ``window = ceil(n / num_windows)`` rounded up to the
vertex tile, so a graph just past the cap gets two half windows rather
than one full window and a sliver. The cap is read from the card's L2
(`l2_bytes`: ``L2_cache_size // 2`` bytes over ``8 · B`` bytes per
vertex). On the CPU there is no L2 to size against, so an adjacency
without a hub tail gets no layout there; tests force windows either
with `window_plan`'s and `sweep_layout`'s ``max_window`` or by replacing
`l2_bytes`, as the reference's tests set its VMEM budget.

:func:`build_bucketed_ell` builds the layout (:class:`WindowSegments`):
the finite in-edges, the ELL's and those of the hub tail its caller
passes, sorted by (source window, destination), with no padding, cut
into *tiles* of consecutive segments of one window that one block of
the CUDA kernel stages in shared memory (at most `TILE_SEGS` segments
and `TILE_EDGES` edges), or one segment longer than the layout's cut
(`block_cut`) alone, which the whole block folds. The windowed
kernel and its plain version (``ref.ell_sweep_bucketed_plain``) both
read these segments. For every (row, window) a segment lists the edges
of the reference package's padded bucket
(``repro.kernels.ell_relax.layout.build_bucketed_ell``), in its order.

Bit-identity: bucketing only re-partitions each vertex's in-edge
multiset, the lexicographic (min, max-at-min) fold is insensitive to
that over exact floats, and dropped ``+inf``-weight padding edges fold
as the identity.

Everything is built with torch on the adjacency's own device, once per
graph: `sweep_layout` caches by tensor identity. A tailed adjacency
gets a layout on every device, of one window where the L2 (or the
CPU's lack of one) calls for none: its sweeps always run through it,
since the dense sweeps read the ELL alone. `BucketedEll.counters` holds
the layout's counts of the tail and of the tiles of one long segment
(`repro_torch.tracing` hands them to each sweep row).

`BucketedEll.gather_gain` measures how much the windowed kernel's prop
gathers cost on this layout, for its activity mask (``windowed.py``):
the edges a segment, times the distinct 32 B sectors of a source plane
that a tile's edges touch, an edge (near 1 where sources are scattered
over the window, as on a random graph; far below it where a tile's
sources crowd a few sectors, as on a lattice in row order, whose
gathers are cheap and gain nothing from the mask).
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import List, NamedTuple, Optional

import torch

from repro_torch.kernels.ell_relax.tail import EllTail

#: bytes per vertex and tree of the two staged source planes
#: (f32 prop + i32 mrank)
PLANE_BYTES = 8

#: segments and edges one block of the windowed kernel stages in
#: shared memory; ``csrc/ell_relax_windowed.cu`` sizes its buffers by
#: the same two constants
TILE_SEGS = 256
TILE_EDGES = 2048
#: the cut of a layout for up to `BLOCK_TREES` trees (`block_cut`): a
#: longer segment is a tile alone, which the kernel's whole block folds
#: (``relax_block`` in the ``.cu``). Folded one thread a tree inside a
#: staged tile, such a segment keeps its block waiting on one thread,
#: and the next window's resuming rows on that block
BLOCK_EDGES = 128
#: the trees the block fold takes at a time (the ``.cu``'s BLOCK_TREES)
BLOCK_TREES = 4

_I32_MAX = 2 ** 31 - 1

#: tiles of a layout, evenly spaced, whose gathers `gather_gain` counts
_GAIN_SAMPLE_TILES = 4096
#: prop values a 32 B sector holds
_SECTOR = 8


def window_cap(l2_bytes: int, *, bb: int, bn: int = 128) -> int:
    """Widest window whose two source-plane slices for ``bb`` trees
    (``8 · bb · W`` bytes) fit half of an L2 of ``l2_bytes``, rounded
    down to the vertex tile (never below one tile)."""
    return max(bn, (int(l2_bytes) // 2 // (PLANE_BYTES * bb)) // bn * bn)


class WindowPlan(NamedTuple):
    """How the n source vertices split into gather windows."""
    window: int        # window width (multiple of bn)
    num_windows: int
    n_pad: int         # window * num_windows >= roundup(n, bn)


def l2_bytes(device) -> Optional[int]:
    """The L2 that source windows are sized against: ``device``'s on a
    CUDA card, None on the CPU, which has none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


def window_plan(n: int, *, bb: int = 8, bn: int = 128,
                max_window: Optional[int] = None,
                device=None) -> WindowPlan:
    """Balanced window split for an n-vertex graph relaxed ``bb`` trees
    at a time. ``max_window`` overrides the cap read from ``device``'s
    L2."""
    if max_window is None:
        l2 = l2_bytes(device)
        if l2 is None:
            raise ValueError(f"the window cap is read from a CUDA card's "
                             f"L2; {device} has none (pass max_window)")
        cap = window_cap(l2, bb=bb, bn=bn)
    else:
        cap = max(bn, int(max_window) // bn * bn)
    n_bn = max(bn, -(-int(n) // bn) * bn)
    if n_bn <= cap:
        return WindowPlan(window=n_bn, num_windows=1, n_pad=n_bn)
    nw = -(-n_bn // cap)
    w = -(-(-(-n_bn // nw)) // bn) * bn
    return WindowPlan(window=w, num_windows=nw, n_pad=nw * w)


def kernel_fits(n: int, *, bb: int = 8, bn: int = 128,
                max_window: Optional[int] = None, device=None) -> bool:
    """Whether one window covers the whole source plane, so the dense
    kernel runs (no bucketing)."""
    return window_plan(n, bb=bb, bn=bn, max_window=max_window,
                       device=device).num_windows == 1


def layout_plan(n: int, device, *, bb: int) -> Optional[WindowPlan]:
    """The plan a sweep of ``bb`` trees over ``device`` runs, from its
    L2; None where there is no L2 to size against (the CPU)."""
    if l2_bytes(device) is None:
        return None
    return window_plan(n, bb=bb, device=device)


class WindowSegments(NamedTuple):
    """The windowed CUDA kernel's layout: the finite in-edges sorted by
    (source window, destination vertex).

    A *segment* is the run of one destination's edges inside one
    window. Window ``wd`` owns segments ``win_segs[wd]`` to
    ``win_segs[wd + 1]``; in each, the segments longer than the
    layout's cut (`block_cut`) come first, longest first, then the
    rest by ascending destination. A segment longer than the cut is a
    tile alone (a *block tile*; a *lone tile* where it passes
    `TILE_EDGES`, the staging buffer). The other segments are cut into
    tiles greedily: a tile of consecutive segments of one window takes
    segments while it holds at most `TILE_SEGS` of them and
    `TILE_EDGES` edges, and ends before a block tile.
    Tile ``t`` owns segments ``tile_segs[t]`` to ``tile_segs[t + 1]``
    and edges ``tile_edges[t]`` to ``tile_edges[t + 1]``; window ``wd``
    owns tiles ``win_tiles[wd]`` to ``win_tiles[wd + 1]``.
    """
    seg_row: torch.Tensor     # i32 [S] destination vertex
    seg_ptr: torch.Tensor     # i64 [S + 1] edge offsets
    seg_flags: torch.Tensor   # u8 [S] bit 0: the row's first segment,
    #                           bit 1: its last
    edge_src: torch.Tensor    # i32 [E] global source vertex
    edge_w: torch.Tensor      # f32 [E] finite weight
    bare_rows: torch.Tensor   # i32 [R] vertices with no finite in-edge
    win_segs: List[int]       # [num_windows + 1] segment offsets
    seg_end: torch.Tensor     # i32 [S] end of the segment's edges,
    #                           counted from its tile's first edge
    tile_segs: torch.Tensor   # i64 [T + 1] segment offsets of the tiles
    tile_edges: torch.Tensor  # i64 [T + 1] edge offsets of the tiles
    win_tiles: List[int]      # [num_windows + 1] tile offsets


class BucketedEll:
    """Source-bucketed pull-ELL adjacency (a plain container).

    ``segments``: the window-major edge list that the CUDA kernel and
    its plain version read; ``gather_gain`` (module docstring) is built
    from it on first access.

    ``block_cut``: the cut (`block_cut`); the kernel folds a tile of
    one longer segment with its whole block.

    ``counters`` (`layout_counters`): ``tail_arcs`` and ``split_rows``
    (the hub tail's arcs and its distinct destinations), ``block_tiles``
    and ``block_tile_edges`` (the tiles of one segment longer than the
    cut, which the kernel's whole block folds, and their edges),
    ``lone_tiles`` and ``lone_tile_edges`` (those of them longer than
    `TILE_EDGES`, which the block reads from device memory rather than
    staged) and ``longest_segment`` (edges).
    """

    def __init__(self, segments: WindowSegments, *, n: int, deg: int,
                 window: int, num_windows: int, n_pad: int, counters: dict,
                 block_cut: int):
        self.segments = segments
        self.counters = counters
        self.block_cut = block_cut
        self.n = n
        self.deg = deg
        self.window = window
        self.num_windows = num_windows
        self.n_pad = n_pad
        self._gain = None

    def plan(self) -> WindowPlan:
        return WindowPlan(self.window, self.num_windows, self.n_pad)

    @property
    def gather_gain(self) -> float:
        """Edges a segment times distinct source sectors an edge, over
        `_GAIN_SAMPLE_TILES` evenly spaced tiles (0.0 without edges)."""
        if self._gain is None:
            self._gain = _gather_gain(self.segments, self.n)
        return self._gain

    def __repr__(self) -> str:                       # pragma: no cover
        return (f"BucketedEll(n={self.n}, deg={self.deg}, "
                f"window={self.window}, num_windows={self.num_windows})")


def block_cut(bb: int) -> int:
    """The cut of a layout for sweeps of ``bb`` trees: a segment longer
    than this is a tile alone, folded by the kernel's whole block.

    `BLOCK_EDGES` up to `BLOCK_TREES` trees, the batch at which it was
    chosen on a real heavy-tailed graph (PERF.md); past it the staging
    buffer (`TILE_EDGES`), so that only the segments no tile can hold
    are block-folded, since the block fold walks the batch a group of
    `BLOCK_TREES` trees at a time."""
    return BLOCK_EDGES if bb <= BLOCK_TREES else TILE_EDGES


def _segments(rows, srcs, ws, wins, n: int, nw: int,
              cut: int) -> WindowSegments:
    """Sort the finite edges by (window, destination) into segments;
    a stable sort keeps each segment's edges in ELL column order. Then
    each window's segments longer than ``cut`` (`_long_first`) move to
    its front."""
    dev = rows.device
    sorted_keys, order = torch.sort(wins * n + rows, stable=True)
    keys, counts = torch.unique_consecutive(sorted_keys,
                                            return_counts=True)
    keys, counts, order = _long_first(keys, counts, order, n, cut)
    seg_row = keys % n
    seg_win = keys // n
    lo = torch.full((n,), nw, dtype=torch.int64, device=dev)
    hi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lo.scatter_reduce_(0, seg_row, seg_win, "amin")
    hi.scatter_reduce_(0, seg_row, seg_win, "amax")
    flags = ((seg_win == lo[seg_row]).to(torch.uint8)
             | ((seg_win == hi[seg_row]).to(torch.uint8) << 1))
    ptr = torch.zeros(keys.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=ptr[1:])
    win_segs = torch.searchsorted(
        seg_win, torch.arange(nw + 1, device=dev)).tolist()
    seg_end, tile_segs, tile_edges, win_tiles = _tiles(ptr, seg_win,
                                                       win_segs, cut)
    return WindowSegments(
        seg_row=seg_row.to(torch.int32), seg_ptr=ptr, seg_flags=flags,
        edge_src=srcs[order].to(torch.int32), edge_w=ws[order],
        bare_rows=torch.nonzero(hi < 0).flatten().to(torch.int32),
        win_segs=win_segs, seg_end=seg_end, tile_segs=tile_segs,
        tile_edges=tile_edges, win_tiles=win_tiles)


def _long_first(keys, counts, order, n: int, cut: int):
    """Segments (``keys`` = window * n + destination, their edge
    ``counts``, and ``order``, the edges segment by segment) with each
    window's segments longer than ``cut`` first, longest first.

    A block tile is the most work of any block of its window's pass:
    at the front, its block starts with the pass, wherever the vertex
    numbering puts its row. A layout without such segments keeps its
    order."""
    past = counts > cut
    if not bool(past.any()):
        return keys, counts, order
    top = int(counts.max()) + 1
    # within a window: segments past the cut by descending length, then
    # the rest, whose equal keys the stable sort keeps in destination
    # order
    rank = torch.where(past, top - 1 - counts, top)
    _, perm = torch.sort(keys // n * (top + 1) + rank, stable=True)
    starts = (torch.cumsum(counts, 0) - counts)[perm]
    counts = counts[perm]
    shift = starts - (torch.cumsum(counts, 0) - counts)
    edge = torch.arange(order.numel(), device=order.device) \
        + torch.repeat_interleave(shift, counts)
    return keys[perm], counts, order[edge]


def _tiles(ptr: torch.Tensor, seg_win: torch.Tensor, win_segs: List[int],
           cut: int):
    """Cut the segments into tiles: (seg_end, tile_segs, tile_edges,
    win_tiles).

    From segment i a tile reaches ``nxt[i]``: as far as `TILE_SEGS`,
    `TILE_EDGES`, the window's end and the next segment longer than
    ``cut`` allow, and at least one segment, so that such a segment is
    a tile alone. The greedy tiles are the chain 0, nxt[0],
    nxt[nxt[0]], ..., walked on the host (one step per tile). Raises if
    a segment's end, counted from its tile's first edge, would not fit
    the kernel's i32.
    """
    dev = ptr.device
    S = ptr.numel() - 1
    i = torch.arange(S, device=dev)
    fit = torch.searchsorted(ptr, ptr[:-1] + TILE_EDGES, right=True) - 1
    win_end = torch.tensor(win_segs, device=dev)[seg_win + 1]
    # the first segment at or after i longer than the cut (S: none)
    long_at = torch.where(ptr.diff() > cut, i, S)
    next_long = long_at.flip(0).cummin(0).values.flip(0)
    nxt = torch.minimum(torch.minimum(i + TILE_SEGS, fit),
                        torch.minimum(win_end, next_long))
    nxt = torch.maximum(nxt, i + 1).cpu().numpy()
    starts, t = [], 0
    while t < S:
        starts.append(t)
        t = int(nxt[t])
    starts.append(S)
    tile_segs = torch.tensor(starts, dtype=torch.int64, device=dev)
    tile_edges = ptr[tile_segs]
    tile_of = torch.searchsorted(tile_segs, i, right=True) - 1
    seg_end = ptr[1:] - tile_edges[tile_of]
    if S and int(seg_end.max()) > _I32_MAX:
        raise ValueError(f"a tile of {int(seg_end.max())} edges does not "
                         "fit the windowed kernel's i32 edge offsets")
    win_tiles = torch.searchsorted(
        tile_segs, torch.tensor(win_segs, device=dev)).tolist()
    return seg_end.to(torch.int32), tile_segs, tile_edges, win_tiles


def _gather_gain(seg: WindowSegments, n: int) -> float:
    """`BucketedEll.gather_gain` of these segments."""
    S, E = seg.seg_row.numel(), seg.edge_src.numel()
    if not E:
        return 0.0
    T = seg.tile_segs.numel() - 1
    pick = torch.arange(0, T, max(1, T // _GAIN_SAMPLE_TILES),
                        device=seg.tile_edges.device)
    lo = seg.tile_edges[pick]
    counts = seg.tile_edges[pick + 1] - lo
    tile = torch.repeat_interleave(torch.arange(pick.numel(),
                                                device=lo.device), counts)
    first = torch.cumsum(counts, 0) - counts
    edge = lo[tile] + torch.arange(tile.numel(), device=lo.device) \
        - first[tile]
    sectors = tile * (n // _SECTOR + 1) + seg.edge_src[edge] // _SECTOR
    distinct = torch.unique(sectors).numel()
    return (E / S) * (distinct / tile.numel())


def layout_counters(seg: WindowSegments, tail: Optional[EllTail],
                    cut: int) -> dict:
    """`BucketedEll.counters` of these segments, built with ``tail``
    and the cut ``cut``."""
    ne = seg.tile_edges.diff()
    block = (seg.tile_segs.diff() == 1) & (ne > cut)
    lone = ne > TILE_EDGES
    lengths = seg.seg_ptr.diff()
    return {"tail_arcs": 0 if tail is None else int(tail.dst.numel()),
            "split_rows": 0 if tail is None else int(
                torch.unique_consecutive(tail.dst).numel()),
            "block_tiles": int(block.sum()),
            "block_tile_edges": int(ne[block].sum()),
            "lone_tiles": int(lone.sum()),
            "lone_tile_edges": int(ne[lone].sum()),
            "longest_segment": int(lengths.max()) if lengths.numel() else 0}


def build_bucketed_ell(ell_src: torch.Tensor, ell_w: torch.Tensor,
                       plan: WindowPlan, *, bb: int,
                       tail: Optional[EllTail] = None) -> BucketedEll:
    """Bucket a pull ELL and its hub ``tail`` (None: the adjacency has
    none) by source window, on the adjacency's device, for sweeps of
    ``bb`` trees (which set the cut, `block_cut`). ``+inf``-weight
    padding edges are dropped."""
    src = ell_src.to(torch.int64)
    w = ell_w.to(torch.float32)
    n, deg = src.shape
    W, nw, n_pad = plan
    # nonzero lists edges row-major, and the tail follows the ELL, so
    # each segment keeps its row's order: ELL columns, then the tail
    rows, cols = torch.nonzero(torch.isfinite(w), as_tuple=True)
    srcs, ws = src[rows, cols], w[rows, cols]
    del src, w, cols
    if tail is not None:
        rows = torch.cat([rows, tail.dst.to(torch.int64)])
        srcs = torch.cat([srcs, tail.src.to(torch.int64)])
        ws = torch.cat([ws, tail.w.to(torch.float32)])
    cut = block_cut(bb)
    seg = _segments(rows, srcs, ws, srcs // W, n, nw, cut)
    return BucketedEll(seg, n=n, deg=deg, window=W, num_windows=nw,
                       n_pad=n_pad, counters=layout_counters(seg, tail, cut),
                       block_cut=cut)


_CACHE_MAX = 4
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def _no_ref():
    """The reference a cache entry keeps where the adjacency has no
    tail."""
    return None


def clear_layout_cache() -> None:
    _cache.clear()


def sweep_layout(ell_src: torch.Tensor, ell_w: torch.Tensor, *, bb: int,
                 tail: Optional[EllTail] = None, bn: int = 128,
                 max_window: Optional[int] = None) -> Optional[BucketedEll]:
    """The bucketed layout a sweep over this adjacency, its pull ELL and
    its hub ``tail`` (None: it has none), runs, relaxing ``bb`` trees at
    a time. The windows are planned from the card's L2, or from
    ``max_window`` where given. With a tail there is a layout on every
    device, of one window where the plan calls for no more (or where
    there is no L2 to plan from, on the CPU). Without one: None where
    one window covers the adjacency (the dense sweep) or no L2 plans
    windows.

    Cached by adjacency and tail identity, plan and cut (id-keyed,
    weakref-validated, small LRU): drivers and policies call it once per
    graph.
    """
    n = int(ell_src.shape[0])
    plan = (layout_plan(n, ell_src.device, bb=bb) if max_window is None
            else window_plan(n, bb=bb, bn=bn, max_window=max_window))
    if tail is None and (plan is None or plan.num_windows <= 1):
        return None
    if plan is None:                               # one window over all n
        plan = window_plan(n, bb=bb, bn=bn, max_window=n + bn)
    anchors = (ell_src, ell_w, None if tail is None else tail.dst)
    key = tuple(map(id, anchors)) + (plan, bn, block_cut(bb))
    hit = _cache.get(key)
    if hit is not None:
        refs, layout = hit
        if all(r() is a for r, a in zip(refs, anchors)):
            _cache.move_to_end(key)
            return layout
        del _cache[key]                        # id reused by a new tensor
    layout = build_bucketed_ell(ell_src, ell_w, plan, bb=bb, tail=tail)
    _cache[key] = (tuple(_no_ref if a is None else weakref.ref(a)
                         for a in anchors), layout)
    while len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
    return layout

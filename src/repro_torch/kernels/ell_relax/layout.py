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
vertex). On the CPU there is no L2 to size against, so no layout is
built there; tests force windows either with `window_plan`'s and
`sweep_layout`'s ``max_window`` or by replacing `l2_bytes`, as the
reference's tests set its VMEM budget.

:func:`build_bucketed_ell` builds the CUDA kernel's window-major layout
(:class:`WindowSegments`): the finite in-edges sorted by (source
window, destination), with no padding, cut into *tiles* of consecutive
segments of one window that one block of the kernel stages in shared
memory (at most `TILE_SEGS` segments and `TILE_EDGES` edges, or one
longer segment alone). The reference package's
bucketed arrays (``src``, ``w``, ``chunk_win``, ``dk``,
``num_chunks``), which pad every row to the densest (row, window)
bucket (4x the adjacency bytes on a random graph), are derived from the
segments on first use only: the plain version
``ref.ell_sweep_bucketed_plain`` reads them, the kernel never does.
They equal ``repro.kernels.ell_relax.layout.build_bucketed_ell``'s
array for array for the same plan.

Bit-identity: bucketing only re-partitions each vertex's in-edge
multiset, the lexicographic (min, max-at-min) fold is insensitive to
that over exact floats, and dropped ``+inf``-weight padding edges fold
as the identity.

Everything is built with torch on the adjacency's own device, once per
graph: `sweep_layout` caches by tensor identity.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import List, NamedTuple, Optional

import torch

#: bytes per vertex and tree of the two staged source planes
#: (f32 prop + i32 mrank)
PLANE_BYTES = 8

#: segments and edges one block of the windowed kernel stages in
#: shared memory; ``csrc/ell_relax_windowed.cu`` sizes its buffers by
#: the same two constants
TILE_SEGS = 256
TILE_EDGES = 2048

_I32_MAX = 2 ** 31 - 1


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
    ``win_segs[wd + 1]``; in each, destinations ascend. A *tile* is a
    run of consecutive segments of one window, cut greedily: it takes
    segments while it holds at most `TILE_SEGS` of them and
    `TILE_EDGES` edges; a segment longer than that is a tile alone.
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

    - ``segments``: the CUDA kernel's window-major edge list;
    - ``src``: i32 ``[n_pad, num_chunks · dk]``, window-local in-edge
      sources (global source minus its window's base);
    - ``w``: f32 ``[n_pad, num_chunks · dk]``, weights, ``+inf``
      padding;
    - ``chunk_win``: i32 ``[n_pad // bn, num_chunks]``, the source
      window chunk c of vertex tile t gathers from; trailing padding
      chunks repeat the tile's last real window.

    ``src``, ``w``, ``chunk_win``, ``dk`` and ``num_chunks`` (the
    reference's format) are built from the segments on first access.
    """

    def __init__(self, segments: WindowSegments, *, n: int, deg: int,
                 window: int, num_windows: int, n_pad: int, bn: int,
                 dk_max: int):
        self.segments = segments
        self.n = n
        self.deg = deg
        self.window = window
        self.num_windows = num_windows
        self.n_pad = n_pad
        self.bn = bn
        self.dk_max = dk_max
        self._padded = None

    def plan(self) -> WindowPlan:
        return WindowPlan(self.window, self.num_windows, self.n_pad)

    def _reference_format(self):
        if self._padded is None:
            self._padded = _pad_buckets(self.segments, self.plan(),
                                        bn=self.bn, dk_max=self.dk_max)
        return self._padded

    src = property(lambda self: self._reference_format()[0])
    w = property(lambda self: self._reference_format()[1])
    chunk_win = property(lambda self: self._reference_format()[2])
    dk = property(lambda self: self._reference_format()[3])
    num_chunks = property(lambda self: self._reference_format()[4])

    def __repr__(self) -> str:                       # pragma: no cover
        return (f"BucketedEll(n={self.n}, deg={self.deg}, "
                f"window={self.window}, num_windows={self.num_windows})")


def _segments(rows, srcs, ws, wins, n: int, nw: int) -> WindowSegments:
    """Sort the finite edges by (window, destination) into segments;
    a stable sort keeps each segment's edges in ELL column order."""
    dev = rows.device
    sorted_keys, order = torch.sort(wins * n + rows, stable=True)
    keys, counts = torch.unique_consecutive(sorted_keys,
                                            return_counts=True)
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
                                                       win_segs)
    return WindowSegments(
        seg_row=seg_row.to(torch.int32), seg_ptr=ptr, seg_flags=flags,
        edge_src=srcs[order].to(torch.int32), edge_w=ws[order],
        bare_rows=torch.nonzero(hi < 0).flatten().to(torch.int32),
        win_segs=win_segs, seg_end=seg_end, tile_segs=tile_segs,
        tile_edges=tile_edges, win_tiles=win_tiles)


def _tiles(ptr: torch.Tensor, seg_win: torch.Tensor, win_segs: List[int]):
    """Cut the segments into tiles: (seg_end, tile_segs, tile_edges,
    win_tiles).

    From segment i a tile reaches ``nxt[i]``: as far as `TILE_SEGS`,
    `TILE_EDGES` and the window's end allow, and at least one segment.
    The greedy tiles are the chain 0, nxt[0], nxt[nxt[0]], ..., walked
    on the host (one step per tile). Raises if a segment's end, counted
    from its tile's first edge, would not fit the kernel's i32.
    """
    dev = ptr.device
    S = ptr.numel() - 1
    i = torch.arange(S, device=dev)
    fit = torch.searchsorted(ptr, ptr[:-1] + TILE_EDGES, right=True) - 1
    win_end = torch.tensor(win_segs, device=dev)[seg_win + 1]
    nxt = torch.minimum(torch.minimum(i + TILE_SEGS, fit), win_end)
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


def _pad_buckets(seg: WindowSegments, plan: WindowPlan, *, bn: int,
                 dk_max: int):
    """The reference's padded arrays from the segments: (src, w,
    chunk_win, dk, num_chunks).

    A segment is one (row, window) bucket, its edges in column order.
    Per vertex tile, each window's buckets pack into consecutive
    ``dk``-wide chunks; ``dk`` adapts to the densest bucket.
    """
    W, nw, n_pad = plan
    dev = seg.seg_row.device
    ntiles = n_pad // bn
    counts = seg.seg_ptr.diff()
    rows_s = seg.seg_row.to(torch.int64)
    wins_s = torch.repeat_interleave(
        torch.arange(nw, device=dev),
        torch.tensor(seg.win_segs, device=dev).diff())
    maxc = int(counts.max()) if counts.numel() else 0
    dk = max(8, min(int(dk_max), -(-max(maxc, 1) // 8) * 8))

    tile_max = torch.zeros(ntiles * nw, dtype=torch.int64, device=dev)
    tile_max.scatter_reduce_(0, rows_s // bn * nw + wins_s, counts, "amax")
    chunks_tw = (-(-tile_max // dk)).view(ntiles, nw)
    ends = torch.cumsum(chunks_tw, 1)
    num_chunks = max(1, int(ends[:, -1].max()))
    slots = torch.arange(num_chunks, device=dev).expand(ntiles, -1)
    chunk_win = torch.searchsorted(ends, slots.contiguous(), right=True)
    last = ((chunks_tw > 0) * torch.arange(nw, device=dev)).amax(1)
    chunk_win = torch.where(chunk_win >= nw, last[:, None], chunk_win)

    # each edge's segment, and its index inside it
    seg_of = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), counts)
    pos = torch.arange(seg_of.numel(), device=dev) - seg.seg_ptr[seg_of]
    rows, wins = rows_s[seg_of], wins_s[seg_of]
    dst = (ends - chunks_tw)[rows // bn, wins] * dk + pos
    src_b = torch.zeros((n_pad, num_chunks * dk), dtype=torch.int32,
                        device=dev)
    w_b = torch.full((n_pad, num_chunks * dk), torch.inf,
                     dtype=torch.float32, device=dev)
    src_b[rows, dst] = (seg.edge_src.to(torch.int64)
                        - wins * W).to(torch.int32)
    w_b[rows, dst] = seg.edge_w
    return src_b, w_b, chunk_win.to(torch.int32), dk, num_chunks


def build_bucketed_ell(ell_src: torch.Tensor, ell_w: torch.Tensor,
                       plan: WindowPlan, *, bn: int = 128,
                       dk_max: int = 128) -> BucketedEll:
    """Bucket a pull ELL by source window, on the adjacency's device.
    ``+inf``-weight padding edges are dropped."""
    src = ell_src.to(torch.int64)
    w = ell_w.to(torch.float32)
    n, deg = src.shape
    W, nw, n_pad = plan
    # nonzero lists edges row-major, so each segment keeps column order
    rows, cols = torch.nonzero(torch.isfinite(w), as_tuple=True)
    srcs = src[rows, cols]
    return BucketedEll(_segments(rows, srcs, w[rows, cols], srcs // W, n,
                                 nw),
                       n=n, deg=deg, window=W, num_windows=nw,
                       n_pad=n_pad, bn=bn, dk_max=dk_max)


_CACHE_MAX = 4
_cache: "OrderedDict[tuple, tuple]" = OrderedDict()


def clear_layout_cache() -> None:
    _cache.clear()


def sweep_layout(ell_src: torch.Tensor, ell_w: torch.Tensor, *, bb: int,
                 bn: int = 128, max_window: Optional[int] = None,
                 dk_max: int = 128) -> Optional[BucketedEll]:
    """The bucketed layout a sweep over this adjacency runs, relaxing
    ``bb`` trees at a time; None when one window covers it (the dense
    kernel) or when it lies on the CPU and no ``max_window`` forces
    windows.

    Cached by adjacency identity (id-keyed, weakref-validated, small
    LRU): drivers and policies call it once per graph.
    """
    n = int(ell_src.shape[0])
    plan = (layout_plan(n, ell_src.device, bb=bb) if max_window is None
            else window_plan(n, bb=bb, bn=bn, max_window=max_window))
    if plan is None or plan.num_windows <= 1:
        return None
    key = (id(ell_src), id(ell_w), plan, bn, dk_max)
    hit = _cache.get(key)
    if hit is not None:
        ref_s, ref_w, layout = hit
        if ref_s() is ell_src and ref_w() is ell_w:
            _cache.move_to_end(key)
            return layout
        del _cache[key]                        # id reused by a new tensor
    layout = build_bucketed_ell(ell_src, ell_w, plan, bn=bn, dk_max=dk_max)
    _cache[key] = (weakref.ref(ell_src), weakref.ref(ell_w), layout)
    while len(_cache) > _CACHE_MAX:
        _cache.popitem(last=False)
    return layout

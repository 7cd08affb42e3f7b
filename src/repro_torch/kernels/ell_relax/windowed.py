"""Wrapper of the hand-written CUDA source-windowed relaxation kernel
(``csrc/ell_relax_windowed.cu``).

`ell_relax_windowed` takes CUDA tensors and a `layout.BucketedEll` built
on the same card. It checks them, allocates the outputs, launches one
pass per source window on the current stream (all from one C call; one
block per tile of the layout) and raises if a launch was refused.
``KERNEL.launches`` counts calls: one per sweep.

The activity mask. Where the layout's gathers can pay for it
(`mask_pays`), the same C call first packs the sweep's mask: a bit per
(live tree, source) whose ``prop`` is finite, `MASK_GROUP` trees a byte,
and the set bits per (window, tree group). Each window then chooses per
tree group, on the device, whether its folds read the mask first and
gather only the sources it allows, or fold every edge as they are
(`gated`). The choice is exact either way. While a sweep row of
`repro_torch.tracing` is open, the counts and the choices go to it
(`tracing.window_stats`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import tracing
from repro_torch.kernels.cuda import (CudaKernel, check_tensors,
                                      current_stream, on_device)
from repro_torch.kernels.ell_relax.ell_relax import plane_specs

#: trees one byte of the activity mask holds
MASK_GROUP = 8
#: the gating rule's two costs, in percent of one scattered prop gather
#: (`PERF.md` gives their measurement): a mask load, which the lanes of
#: ``WARP_TREES`` trees share, and the gated fold's own cost for each
#: (segment, live tree) pair
MASK_COST_PCT = 75
SEGMENT_COST_PCT = 150
#: the live trees a warp of the gated fold holds at one run of segments
WARP_TREES = 4
#: a batch of more trees runs ungated (its live trees are one 64-bit word)
GATE_TREES = 64
# (each constant is the one of the same name in the ``.cu``)

KERNEL = CudaKernel(
    "ell_relax_windowed",
    Path(__file__).resolve().parent / "csrc" / "ell_relax_windowed.cu",
    argtypes=[ctypes.c_void_p] * 18 + [ctypes.c_longlong] * 7
    + [ctypes.c_double, ctypes.c_void_p])


def gated(live: int, density: float, gain: float) -> bool:
    """The kernel's choice for a (window, tree group) of ``live`` live
    trees at finite-source ``density`` (set bits over live trees times
    the window's vertices) on a layout of gather gain ``gain``
    (`layout.BucketedEll.gather_gain`), in the kernel's arithmetic: the
    scattered gathers the mask saves a (segment, live tree) pair, ``gain
    * (1 - density)``, against its mask loads and the gated fold's own
    cost."""
    if not live:
        return False
    masks = -(-live // WARP_TREES) / live
    return (gain * (100.0 * (1.0 - density) - MASK_COST_PCT * masks)
            >= SEGMENT_COST_PCT)


def mask_pays(B: int, layout) -> bool:
    """Whether a sweep of ``B`` trees over ``layout`` packs the mask: a
    window of ``WARP_TREES`` live trees and no finite source would take
    the gated fold (the best case), and the batch has at most
    `GATE_TREES` trees. Where it does not, the sweep runs as it would
    without the mask."""
    return B <= GATE_TREES and gated(WARP_TREES, 0.0, layout.gather_gain)


def ell_relax_windowed(dist, mrank, prop, alive, layout, rank):
    """One sweep on the card over a source-windowed layout:
    (new_dist f32 [B, n], new_mrank i32 [B, n]).

    dist/mrank/prop [B, n], alive bool [B] and rank i32 [n] as for
    `ell_relax`; ``layout`` is the graph's `BucketedEll`, whose
    ``segments`` the kernel reads.
    """
    B, n = dist.shape
    if layout.n != n:
        raise ValueError(f"ell_relax_windowed: layout is for n={layout.n},"
                         f" planes have n={n}")
    s = layout.segments
    S, E = s.seg_row.shape[0], s.edge_src.shape[0]
    T = s.tile_segs.shape[0] - 1
    check_tensors("ell_relax_windowed", dist.device,
                  plane_specs(dist, mrank, prop, alive, rank)
                  + [("seg_row", s.seg_row, torch.int32, (S,)),
                     ("seg_flags", s.seg_flags, torch.uint8, (S,)),
                     ("seg_end", s.seg_end, torch.int32, (S,)),
                     ("tile_segs", s.tile_segs, torch.int64, (T + 1,)),
                     ("tile_edges", s.tile_edges, torch.int64, (T + 1,)),
                     ("edge_src", s.edge_src, torch.int32, (E,)),
                     ("edge_w", s.edge_w, torch.float32, (E,)),
                     ("bare_rows", s.bare_rows, torch.int32, (None,))])
    nw = layout.num_windows
    if len(s.win_tiles) != nw + 1 or s.win_tiles[-1] != T:
        raise ValueError("ell_relax_windowed: window offsets do not cover "
                         "the tiles")
    if layout.window % 32:
        raise ValueError("ell_relax_windowed: the window must be a "
                         "multiple of 32 vertices (a warp of the mask's "
                         "pack pass counts into one window)")
    if s.edge_src.data_ptr() % 16 or s.edge_w.data_ptr() % 16:
        raise ValueError("ell_relax_windowed: the edges must start on a "
                         "16-byte boundary (the kernel loads them as "
                         "16-byte vectors)")
    out_d = torch.empty_like(dist)
    out_m = torch.empty_like(mrank)
    if B and n:
        mask = stats = None
        if mask_pays(B, layout):
            groups = -(-B // MASK_GROUP)
            mask = torch.empty((groups, n), dtype=torch.uint8,
                               device=dist.device)
            # [set bits, choices (1: gated)] per (window, group), then
            # the kernel's own words (each window's choices, padding to
            # even, the live trees)
            counts = 2 * nw * groups
            stats = torch.empty(counts + nw + (counts + nw) % 2 + 2,
                                dtype=torch.int32, device=dist.device)
        win_tiles = (ctypes.c_longlong * (nw + 1))(*s.win_tiles)
        with on_device(dist.device):
            KERNEL.launch(*(t.data_ptr() for t in (
                dist, mrank, prop, alive, s.seg_row, s.seg_flags,
                s.seg_end, s.tile_segs, s.tile_edges, s.edge_src, s.edge_w,
                rank, s.bare_rows, out_d, out_m)),
                None if mask is None else mask.data_ptr(),
                None if stats is None else stats.data_ptr(),
                ctypes.cast(win_tiles, ctypes.c_void_p), nw,
                s.bare_rows.shape[0], E, B, n, layout.window,
                layout.block_cut, layout.gather_gain,
                current_stream(dist.device))
        if stats is not None:
            tracing.window_stats(stats[:counts].view(2, nw, groups))
    return out_d, out_m

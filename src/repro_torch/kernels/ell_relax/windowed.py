"""Wrapper of the hand-written CUDA source-windowed relaxation kernel
(``csrc/ell_relax_windowed.cu``).

`ell_relax_windowed` takes CUDA tensors and a `layout.BucketedEll` built
on the same card. It checks them, allocates the outputs, launches one
pass per source window on the current stream (all from one C call; one
block per tile of the layout) and raises if a launch was refused.
``KERNEL.launches`` counts calls: one per sweep.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors,
                                      current_stream, on_device)
from repro_torch.kernels.ell_relax.ell_relax import plane_specs

KERNEL = CudaKernel(
    "ell_relax_windowed",
    Path(__file__).resolve().parent / "csrc" / "ell_relax_windowed.cu",
    argtypes=[ctypes.c_void_p] * 16 + [ctypes.c_longlong] * 5
    + [ctypes.c_void_p])


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
    if s.edge_src.data_ptr() % 16 or s.edge_w.data_ptr() % 16:
        raise ValueError("ell_relax_windowed: the edges must start on a "
                         "16-byte boundary (the kernel loads them as "
                         "16-byte vectors)")
    out_d = torch.empty_like(dist)
    out_m = torch.empty_like(mrank)
    if B and n:
        win_tiles = (ctypes.c_longlong * (nw + 1))(*s.win_tiles)
        with on_device(dist.device):
            KERNEL.launch(*(t.data_ptr() for t in (
                dist, mrank, prop, alive, s.seg_row, s.seg_flags,
                s.seg_end, s.tile_segs, s.tile_edges, s.edge_src, s.edge_w,
                rank, s.bare_rows, out_d, out_m)),
                ctypes.cast(win_tiles, ctypes.c_void_p), nw,
                s.bare_rows.shape[0], E, B, n, current_stream(dist.device))
    return out_d, out_m

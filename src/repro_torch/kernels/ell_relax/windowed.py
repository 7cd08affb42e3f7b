"""Wrapper of the hand-written CUDA source-windowed relaxation kernel
(``csrc/ell_relax_windowed.cu``).

`ell_relax_windowed` takes CUDA tensors and a `layout.BucketedEll` built
on the same card. It checks them, allocates the outputs, launches one
pass per source window on the current stream (all from one C call) and
raises if a launch was refused. ``KERNEL.launches`` counts calls: one
per sweep.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors, ptr,
                                      stream_of)
from repro_torch.kernels.ell_relax.ell_relax import plane_specs

KERNEL = CudaKernel(
    "ell_relax_windowed",
    Path(__file__).resolve().parent / "csrc" / "ell_relax_windowed.cu",
    argtypes=[ctypes.c_void_p] * 14 + [ctypes.c_longlong] * 4
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
    check_tensors("ell_relax_windowed", dist.device,
                  plane_specs(dist, mrank, prop, alive, rank)
                  + [("seg_row", s.seg_row, torch.int32, (S,)),
                     ("seg_ptr", s.seg_ptr, torch.int64, (S + 1,)),
                     ("seg_flags", s.seg_flags, torch.uint8, (S,)),
                     ("edge_src", s.edge_src, torch.int32, (E,)),
                     ("edge_w", s.edge_w, torch.float32, (E,)),
                     ("bare_rows", s.bare_rows, torch.int32, (None,))])
    if len(s.win_segs) != layout.num_windows + 1 or s.win_segs[-1] != S:
        raise ValueError("ell_relax_windowed: window offsets do not cover "
                         "the segments")
    out_d = torch.empty_like(dist)
    out_m = torch.empty_like(mrank)
    if B and n:
        win_segs = (ctypes.c_longlong * len(s.win_segs))(*s.win_segs)
        with torch.cuda.device(dist.device):
            KERNEL.launch(ptr(dist), ptr(mrank), ptr(prop), ptr(alive),
                          ptr(s.seg_row), ptr(s.seg_ptr), ptr(s.seg_flags),
                          ptr(s.edge_src), ptr(s.edge_w), ptr(rank),
                          ptr(s.bare_rows), ptr(out_d), ptr(out_m),
                          ctypes.cast(win_segs, ctypes.c_void_p),
                          layout.num_windows, s.bare_rows.shape[0], B, n,
                          stream_of(dist))
    return out_d, out_m

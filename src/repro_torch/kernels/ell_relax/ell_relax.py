"""Wrapper of the hand-written CUDA ELL relaxation kernel
(``csrc/ell_relax.cu``).

`ell_relax` takes CUDA tensors only. It checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream and
raises if the launch was refused. ``KERNEL.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors, ptr,
                                      stream_of)

KERNEL = CudaKernel(
    "ell_relax", Path(__file__).resolve().parent / "csrc" / "ell_relax.cu",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p])


def plane_specs(dist, mrank, prop, alive, rank):
    """The sweep's state operands: ``(name, tensor, dtype, shape)``."""
    B, n = dist.shape
    return [("dist", dist, torch.float32, (B, n)),
            ("mrank", mrank, torch.int32, (B, n)),
            ("prop", prop, torch.float32, (B, n)),
            ("alive", alive, torch.bool, (B,)),
            ("rank", rank, torch.int32, (n,))]


def check_operands(dist, mrank, prop, alive, ell_src, ell_w, rank) -> None:
    """Raise ValueError on anything the kernel does not take."""
    n = dist.shape[1]
    deg = ell_src.shape[1] if ell_src.dim() == 2 else -1
    check_tensors("ell_relax", dist.device,
                  plane_specs(dist, mrank, prop, alive, rank)
                  + [("ell_src", ell_src, torch.int32, (n, deg)),
                     ("ell_w", ell_w, torch.float32, (n, deg))])


def ell_relax(dist, mrank, prop, alive, ell_src, ell_w, rank):
    """One sweep on the card: (new_dist f32 [B, n], new_mrank i32 [B, n]).

    dist/mrank [B, n]; prop [B, n] (dist masked to +inf at blocked and
    out-of-frontier sources); alive bool [B] (False retires the tree);
    ell_src i32 / ell_w f32 [n, deg]; rank i32 [n].
    """
    check_operands(dist, mrank, prop, alive, ell_src, ell_w, rank)
    B, n = dist.shape
    out_d = torch.empty_like(dist)
    out_m = torch.empty_like(mrank)
    if B and n:
        with torch.cuda.device(dist.device):
            KERNEL.launch(ptr(dist), ptr(mrank), ptr(prop), ptr(alive),
                          ptr(ell_src), ptr(ell_w), ptr(rank), ptr(out_d),
                          ptr(out_m), B, n, ell_src.shape[1],
                          stream_of(dist))
    return out_d, out_m

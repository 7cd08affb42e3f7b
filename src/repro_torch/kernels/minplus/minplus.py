"""Wrapper of the hand-written CUDA lexicographic (min, +) kernel
(``csrc/minplus.cu``).

`minplus` takes CUDA tensors only. It checks device, dtype, shape and
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
    "minplus", Path(__file__).resolve().parent / "csrc" / "minplus.cu",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p])


def minplus(dist, mrank, w):
    """(out_d f32 [B, N], out_m i32 [B, N]) on the card for dist f32 /
    mrank i32 [B, K] and the dense weight block w f32 [K, N] (+inf = no
    edge); any B, K and N."""
    B, K = dist.shape
    N = w.shape[1] if w.dim() == 2 else -1
    check_tensors("minplus", dist.device,
                  [("dist", dist, torch.float32, (B, K)),
                   ("mrank", mrank, torch.int32, (B, K)),
                   ("w", w, torch.float32, (K, N))])
    out_d = torch.empty((B, N), dtype=torch.float32, device=dist.device)
    out_m = torch.empty((B, N), dtype=torch.int32, device=dist.device)
    if B and K and N:
        with torch.cuda.device(dist.device):
            KERNEL.launch(ptr(dist), ptr(mrank), ptr(w), ptr(out_d),
                          ptr(out_m), B, K, N, stream_of(dist))
    else:                                   # an empty fold: no candidate
        out_d.fill_(torch.inf)
        out_m.fill_(-1)
    return out_d, out_m

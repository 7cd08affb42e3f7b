"""Wrapper of the hand-written CUDA lexicographic (min, +) kernel
(``csrc/minplus.cu``).

`minplus` takes CUDA tensors only. It checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream and
raises if the launch was refused. ``KERNEL.launches`` counts launches.
`launch_geometry` is the launch's shape, a pure function the CPU tests
call.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors,
                                      current_stream, on_device)

KERNEL = CudaKernel(
    "minplus", Path(__file__).resolve().parent / "csrc" / "minplus.cu",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p])

#: the kernel's tiling: output rows and columns per block, K per stage,
#: stages in the shared-memory ring, threads per block and the blocks an
#: SM holds (its launch bounds; three stages of 33,792 B each fit twice)
TB, TN, TK, NSTAGE, THREADS, BLOCKS_PER_SM = 64, 128, 32, 3, 256, 2
#: rows and columns of one thread's register tile
RI, CJ = 8, 4


def launch_geometry(B: int, N: int, sms: int):
    """``(grid_x, grid_y, blocks, waves)`` of one product with B rows and
    N columns on a card of ``sms`` SMs: one block per TB x TN output
    tile, and the blocks over the ``sms * BLOCKS_PER_SM`` that are
    resident at once."""
    gx, gy = -(-N // TN), -(-B // TB)
    return gx, gy, gx * gy, gx * gy / (sms * BLOCKS_PER_SM)


def thread_outputs(B: int, N: int, bx: int, by: int, tid: int):
    """The (row, column) outputs that thread ``tid`` of block ``(bx,
    by)`` stores: the kernel's index arithmetic, for the tests."""
    ty, tx = divmod(tid, 32)
    rows = (by * TB + ty * RI + i for i in range(RI))
    return [(b, v) for b in rows if b < B
            for v in (bx * TN + tx * CJ + j for j in range(CJ)) if v < N]


def minplus(dist, mrank, w):
    """(out_d f32 [B, N], out_m i32 [B, N]) on the card for dist f32 /
    mrank i32 [B, K] and the dense weight block w f32 [K, N] (+inf = no
    edge); any B, K and N."""
    B, K = dist.shape if dist.dim() == 2 else (-1, -1)
    N = w.shape[1] if w.dim() == 2 else -1
    check_tensors("minplus", dist.device,
                  [("dist", dist, torch.float32, (B, K)),
                   ("mrank", mrank, torch.int32, (B, K)),
                   ("w", w, torch.float32, (K, N))])
    dev = dist.device
    out_d = torch.empty((B, N), dtype=torch.float32, device=dev)
    out_m = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B and K and N:
        with on_device(dev):
            KERNEL.launch(dist.data_ptr(), mrank.data_ptr(), w.data_ptr(),
                          out_d.data_ptr(), out_m.data_ptr(), B, K, N,
                          current_stream(dev))
    else:                                   # an empty fold: no candidate
        out_d.fill_(torch.inf)
        out_m.fill_(-1)
    return out_d, out_m

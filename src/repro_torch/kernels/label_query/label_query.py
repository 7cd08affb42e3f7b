"""Wrapper of the hand-written CUDA label-intersection kernel
(``csrc/label_query.cu``).

`label_query` takes CUDA tensors only; it checks device, dtype, shape
and contiguity, allocates the outputs, launches on the current stream
and raises if the launch was refused. ``KERNEL.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors,
                                      current_stream, on_device)

KERNEL = CudaKernel(
    "label_query",
    Path(__file__).resolve().parent / "csrc" / "label_query.cu",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p])


def label_query(hubs_u, dist_u, hubs_v, dist_v):
    """(dist f32 [Q], hub i32 [Q]) for label rows hubs_* i32 /
    dist_* f32 [Q, L] on the card; any Q and L."""
    Q, L = hubs_u.shape
    check_tensors("label_query", hubs_u.device,
                  [(name, t, dtype, (Q, L)) for name, t, dtype in
                   (("hubs_u", hubs_u, torch.int32),
                    ("dist_u", dist_u, torch.float32),
                    ("hubs_v", hubs_v, torch.int32),
                    ("dist_v", dist_v, torch.float32))])
    out_d = torch.empty(Q, dtype=torch.float32, device=hubs_u.device)
    out_h = torch.empty(Q, dtype=torch.int32, device=hubs_u.device)
    if Q and L:
        with on_device(hubs_u.device):
            KERNEL.launch(hubs_u.data_ptr(), dist_u.data_ptr(),
                          hubs_v.data_ptr(), dist_v.data_ptr(),
                          out_d.data_ptr(), out_h.data_ptr(), Q, L,
                          current_stream(hubs_u.device))
    elif Q:
        out_d.fill_(torch.inf)
        out_h.fill_(-1)
    return out_d, out_h

"""Wrapper of the hand-written CUDA ELL relaxation kernel
(``csrc/ell_relax.cu``).

`ell_relax` takes CUDA tensors only. It checks device, dtype, shape and
contiguity, allocates the outputs, launches on the current stream and
raises if the launch was refused. ``KERNEL.launches`` counts launches.
`launch_geometry` is the launch's shape: a pure function of
``(B, n, sm_count)`` that the CPU tests call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors,
                                      current_stream, on_device, sm_count)

KERNEL = CudaKernel(
    "ell_relax", Path(__file__).resolve().parent / "csrc" / "ell_relax.cu",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p])

#: the kernel's tile: vertices per block, tree slots per block (a slot is
#: TILE_V threads), and the staged ELL slots of a block (a tile's padded
#: rows stage in shared memory while TILE_V * deg <= EDGE_SLOTS)
TILE_V = 64
MAX_SLOTS = 4
EDGE_SLOTS = 2048
#: trees a thread may take, and the resident threads of one SM
TREE_GROUPS = (1, 2, 4)
THREADS_PER_SM = 2048
#: work items wanted per resident thread of the card before a thread
#: takes more trees. Measured on the H100 (PERF.md): at the
#: mid-size states (B = 4, n ~ 800K) two trees a thread beat one on the
#: road graph and one tree beat two on the random graph; 4 keeps G = 2
#: there, the choice that beats the parent's kernel on both
FILL = 4


@lru_cache(maxsize=256)
def launch_geometry(B: int, n: int, sms: int):
    """``(G, S, threads, blocks)`` of one sweep over ``B`` trees and ``n``
    vertices on a card of ``sms`` SMs.

    G, the trees a thread takes, is the largest of `TREE_GROUPS` (at most
    B) that still leaves ``FILL`` work items per resident thread, so a
    small sweep spreads over the card and a very large one amortises a
    thread's row loads over several trees. S, the block's tree slots,
    is at most `MAX_SLOTS` and no more than the B / G tree groups need.
    A block covers TILE_V vertices and S * G trees; its blocks are
    ``ceil(n / TILE_V)`` tiles times ``ceil(B / (S * G))`` tree chunks.
    """
    resident = sms * THREADS_PER_SM
    G = 1
    for g in TREE_GROUPS[1:]:
        if g <= B and -(-B // g) * n >= FILL * resident:
            G = g
    S = max(1, min(MAX_SLOTS, -(-B // G)))
    blocks = -(-n // TILE_V) * -(-B // (S * G))
    return G, S, TILE_V * S, blocks


def work_items(B: int, n: int, G: int, S: int, block: int, thread: int):
    """The (tree, vertex) pairs that thread ``thread`` of block ``block``
    relaxes: the kernel's index arithmetic, for the tests."""
    chunks = -(-B // (S * G))
    tile, chunk = divmod(block, chunks)
    v = tile * TILE_V + thread % TILE_V
    if v >= n:
        return []
    s = thread // TILE_V
    trees = (chunk * S * G + g * S + s for g in range(G))
    return [(b, v) for b in trees if b < B]


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
    n = dist.shape[1] if dist.dim() == 2 else -1
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
        dev = dist.device
        G, S, _, blocks = launch_geometry(B, n, sm_count(dev))
        with on_device(dev):
            KERNEL.launch(dist.data_ptr(), mrank.data_ptr(), prop.data_ptr(),
                          alive.data_ptr(), ell_src.data_ptr(),
                          ell_w.data_ptr(), rank.data_ptr(),
                          out_d.data_ptr(), out_m.data_ptr(), B, n,
                          ell_src.shape[1], G, S, blocks,
                          current_stream(dev))
    return out_d, out_m

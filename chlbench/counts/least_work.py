"""The least work a PLaNT batch needs, worked from its inputs alone.

Frozen: it counts what a batch's trees must touch, whatever computes
them, so no implementation (fused, frontier-only, windowed) can read
over 100 % of it. For a batch of ``B`` trees whose record says they
explored ``explored`` (tree, vertex) pairs:

- writes: each explored (tree, vertex) holds a distance and a max-rank
  at the end, written once: 8 B each;
- reads: each explored vertex's in-edges (source and weight, 8 B an
  edge) and its rank (4 B), once for the whole batch. The vertices the
  batch explored are at least ``explored // B`` (the largest tree is at
  least the mean), and their in-edges at least the in-degrees of that
  many vertices of least in-degree;
- operations: one add, one compare and one max per in-edge read, at the
  f32 rate.

The least time is the larger of bytes over the memory bandwidth and
operations over the f32 rate (`h100.json`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

PEAKS_FILE = Path(__file__).resolve().parent / "h100.json"


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def in_degree_prefix(n: int, src: np.ndarray, dst: np.ndarray,
                     device="cpu") -> np.ndarray:
    """``p[k]``: the in-edges of the ``k`` vertices of least in-degree in
    the simple undirected graph of the edge list (self loops dropped, a
    repeated pair counted once), ``k`` in [0, n]."""
    import torch
    a = torch.as_tensor(src, device=device).long()
    b = torch.as_tensor(dst, device=device).long()
    keep = a != b
    lo, hi = torch.minimum(a, b)[keep], torch.maximum(a, b)[keep]
    key = torch.unique(lo * n + hi)
    deg = (torch.bincount(torch.div(key, n, rounding_mode="floor"),
                          minlength=n)
           + torch.bincount(key % n, minlength=n))
    out = np.zeros(n + 1, dtype=np.int64)
    out[1:] = torch.cumsum(torch.sort(deg).values, 0).cpu().numpy()
    return out


def batch_work(explored: int, batch: int, prefix: np.ndarray
               ) -> Tuple[int, int]:
    """``(bytes, operations)`` a batch of ``batch`` trees that explored
    ``explored`` (tree, vertex) pairs needs at least."""
    union = int(explored) // int(batch)
    edges = int(prefix[min(union, len(prefix) - 1)])
    return 8 * int(explored) + 4 * union + 8 * edges, 3 * edges


def least_seconds(nbytes: int, ops: int, pk: dict) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["f32_ops_per_s"])

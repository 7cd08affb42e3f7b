"""Degree ranking, worked out from the edge list.

A vertex's degree is the number of edge-list entries it ends (a
repeated pair counts twice; the generators drop self loops). Larger
degree ranks higher; ties go to the smaller vertex id. ``rank[v]`` is a
permutation of [0, n), n - 1 the most important, the port's convention.
"""

from __future__ import annotations

import numpy as np


def rank(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    deg = (np.bincount(src, minlength=n)
           + np.bincount(dst, minlength=n)).astype(np.int64)
    order = np.lexsort((np.arange(n), -deg))
    out = np.empty(n, dtype=np.int32)
    out[order] = np.arange(n - 1, -1, -1, dtype=np.int32)
    return out

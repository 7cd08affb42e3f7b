"""Root ordering and fixed-size batching for the superstep engine."""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np


def rank_order(rank: np.ndarray) -> np.ndarray:
    """Rank-descending root order (stable — ties break by vertex id)."""
    return np.argsort(-np.asarray(rank).astype(np.int64), kind="stable")


def root_batches(order: np.ndarray, batch: int):
    """Yield ``(roots[B], valid[B])`` fixed-size batches over a root
    order; the last batch is padded with root 0, marked invalid."""
    n = len(order)
    for s in range(0, n, batch):
        chunk = order[s:s + batch]
        pad = batch - len(chunk)
        roots = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
        valid = np.concatenate([np.ones(len(chunk), bool),
                                np.zeros(pad, bool)])
        yield roots.astype(np.int32), valid


class Step(NamedTuple):
    """One schedulable unit of construction work."""
    pos: int                  # root cursor before this step
    end: int                  # root cursor after this step commits
    roots: np.ndarray         # [B] root ids
    valid: np.ndarray         # [B], False on padding
    next_size: Optional[int]  # growth cursor (None: batch schedules)


class BatchSchedule:
    """Fixed-size batches over one global root order."""

    def __init__(self, order: np.ndarray, batch: int):
        self.order = np.asarray(order)
        self.batch = int(batch)
        self.total = len(self.order)

    def steps(self, start: int = 0) -> Iterator[Step]:
        pos = int(start)
        for roots, valid in root_batches(self.order[start:], self.batch):
            yield Step(pos=pos, end=min(pos + self.batch, self.total),
                       roots=roots, valid=valid, next_size=None)
            pos += self.batch

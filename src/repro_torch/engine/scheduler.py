"""Root ordering, batching and superstep growth for the superstep engine.

Two shapes of schedule:

- :class:`BatchSchedule` — one global rank-descending root order cut
  into fixed-size batches (the single-host policies). A resume
  re-enters on the original batch boundaries.
- :class:`QueueSchedule` — per-node round-robin root queues
  (`repro_torch.core.dgll.assign_roots`) walked in supersteps that grow
  geometrically by ``beta`` (§5.1: synchronization points set a
  priori). The growth cursor (``next_size``) travels with every step,
  so a resumed run continues the same growth sequence.
"""

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


def pad_step(queues: np.ndarray, pos: int, T: int, batch: int
             ) -> np.ndarray:
    """``T`` columns of the per-node queues from column ``pos``, padded
    with -1 (``batch`` is the reference's signature; unused)."""
    del batch
    q, per = queues.shape
    out = np.full((q, T), -1, dtype=np.int32)
    take = min(T, per - pos)
    out[:, :take] = queues[:, pos:pos + take]
    return out


class Step(NamedTuple):
    """One schedulable unit of construction work."""
    pos: int                  # root cursor before this step
    end: int                  # root cursor after this step commits
    roots: np.ndarray         # [B] (batch) or [q, T] (queue) root ids
    valid: np.ndarray         # same shape, False on padding
    next_size: Optional[int]  # growth cursor (None: batch schedules)


class BatchSchedule:
    """Fixed-size batches over one global root order."""

    def __init__(self, order: np.ndarray, batch: int):
        self.order = np.asarray(order)
        self.batch = int(batch)
        self.total = len(self.order)

    def steps(self, start: int = 0,
              size: Optional[int] = None) -> Iterator[Step]:
        """Steps from root cursor ``start`` (a resume re-enters on the
        original batch boundaries); ``size`` is the growth cursor of
        the reference's queue schedules, unused here."""
        del size
        pos = int(start)
        for roots, valid in root_batches(self.order[start:], self.batch):
            yield Step(pos=pos, end=min(pos + self.batch, self.total),
                       roots=roots, valid=valid, next_size=None)
            pos += self.batch


class QueueSchedule:
    """Per-node root queues walked in geometrically growing supersteps.

    ``queues`` is the ``[q, per]`` round-robin assignment of
    `repro_torch.core.dgll.assign_roots`; every superstep covers ``T``
    columns a node (rounded up to a multiple of ``batch``), and the
    target size multiplies by ``beta`` after each superstep.
    """

    def __init__(self, queues: np.ndarray, batch: int, beta: float,
                 first_superstep: int = 1):
        self.queues = np.asarray(queues)
        self.batch = int(batch)
        self.beta = float(beta)
        self.first_superstep = int(first_superstep)
        self.total = int(self.queues.shape[1])     # columns per node

    def steps(self, start: int = 0,
              size: Optional[int] = None) -> Iterator[Step]:
        pos = int(start)
        size = self.first_superstep if size is None else int(size)
        while pos < self.total:
            T = min(size, self.total - pos)
            T = -(-T // self.batch) * self.batch   # multiple of batch
            roots = pad_step(self.queues, pos, T, batch=self.batch)
            size = int(size * self.beta)
            yield Step(pos=pos, end=pos + T, roots=roots,
                       valid=roots >= 0, next_size=size)
            pos += T

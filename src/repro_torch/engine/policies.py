"""Construction policies — each algorithm as a thin plug into the engine.

A policy is what is left of a construction algorithm once the engine
owns the loop: the per-batch device step and the emission filter.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.plant import plant_batch
from repro_torch.engine.records import pack_stats
from repro_torch.engine.scheduler import BatchSchedule, Step, rank_order
from repro_torch.graphs.graph import device_arrays
from repro_torch.sssp.relax import ell_layout


class StepOutcome(NamedTuple):
    """What a policy hands back when a superstep commits: its packed
    device ``stats`` row, fetched with all others after the loop."""

    mode: str
    stats: torch.Tensor
    trees: Optional[int] = None


def build_fingerprint(g, rank: np.ndarray) -> str:
    """Stable fingerprint of (graph, hierarchy), as the reference
    computes it — what checkpoints will carry once they are ported, so
    that a resume never adopts labels of another build."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(
        np.asarray(rank).astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(g.ell_src).astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(g.ell_w).astype(np.float64)).tobytes())
    return h.hexdigest()


class Policy:
    """Interface the engine drives. Subclasses override what they use."""

    name: str = "?"

    def schedule(self):
        raise NotImplementedError

    def step(self, st: Step, sink) -> Optional[StepOutcome]:
        """Process one scheduled step; ``None`` = buffered, no commit."""
        raise NotImplementedError


class PlantPolicy(Policy):
    """PLaNT (§5.2): unpruned max-rank-ancestor trees, zero cross-tree
    dependence — emissions are canonical on arrival."""

    name = "plant"

    def __init__(self, g, rank: np.ndarray, *, batch: int, device,
                 roots_order: Optional[np.ndarray] = None):
        self.batch = int(batch)
        self.order = (np.asarray(roots_order) if roots_order is not None
                      else rank_order(rank))
        self.arrays = device_arrays(g, rank, device)
        self.device = self.arrays.ell_src.device
        # the source-bucketed layout (None when one window covers the
        # graph), built once per graph rather than per batch
        self.layout = ell_layout(self.arrays.ell_src, self.arrays.ell_w,
                                 batch=self.batch)

    def schedule(self) -> BatchSchedule:
        return BatchSchedule(self.order, self.batch)

    def step(self, st: Step, sink) -> StepOutcome:
        a = self.arrays
        roots_d = torch.as_tensor(st.roots, device=self.device)
        valid_d = torch.as_tensor(st.valid, device=self.device)
        tb = plant_batch(a.ell_src, a.ell_w, a.rank, roots_d, valid_d,
                         layout=self.layout)
        sink.insert(roots_d, tb.emit, tb.dist)
        stats = pack_stats(tb.emit.sum(dtype=torch.int32),
                           (tb.explored * valid_d).sum(dtype=torch.int32),
                           tb.sweeps, device=self.device)
        return StepOutcome(mode=self.name, stats=stats,
                           trees=int(st.valid.sum()))

"""Typed per-superstep records and the packed one-fetch stats protocol.

A policy packs its per-superstep scalars into one small device tensor
(:func:`pack_stats`); the engine keeps the rows and
:func:`fetch_stat_rows` moves them to the host in one transfer after
the loop, so the build never waits on the device once per superstep
for its statistics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

#: slot layout of a packed per-superstep stats row (i32)
STAT_SLOTS = ("labels", "explored", "sweeps", "overflow",
              "compact_overflow")


@dataclasses.dataclass(frozen=True)
class SuperstepRecord:
    """One committed superstep (or root batch) of construction — the
    row type of ``BuildReport.supersteps``."""

    mode: str                       # plant | ...
    labels: Optional[int] = None    # labels committed
    explored: Optional[int] = None  # vertices touched (Ψ numerator)
    sweeps: Optional[int] = None    # relaxation sweeps to fixpoint
    psi: Optional[float] = None     # explored per label
    trees: Optional[int] = None     # roots processed this superstep

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def make_record(mode: str, labels: Optional[int] = None,
                explored: Optional[int] = None,
                sweeps: Optional[int] = None,
                trees: Optional[int] = None) -> SuperstepRecord:
    """Record with Ψ derived whenever both inputs are present."""
    psi = None
    if labels is not None and explored is not None:
        psi = explored / max(1, labels)
    return SuperstepRecord(mode=mode, labels=labels, explored=explored,
                           sweeps=sweeps, psi=psi, trees=trees)


def pack_stats(labels, explored, sweeps=None, overflow=None,
               compact_overflow=None, *, device=None) -> torch.Tensor:
    """Pack one superstep's scalars (tensors or ints; missing slots
    become -1 / 0) into a single ``[5]`` int32 tensor."""
    def slot(x, missing):
        x = missing if x is None else x
        return torch.as_tensor(x, device=device).to(torch.int32)

    return torch.stack([
        slot(labels, -1), slot(explored, -1), slot(sweeps, -1),
        slot(overflow, 0), slot(compact_overflow, 0)])


def fetch_stat_rows(rows: List[torch.Tensor]) -> np.ndarray:
    """All deferred superstep rows in ONE blocking device fetch."""
    if not rows:
        return np.zeros((0, len(STAT_SLOTS)), dtype=np.int64)
    return torch.stack(rows).cpu().numpy().astype(np.int64)


def record_from_row(mode: str, row: np.ndarray,
                    trees: Optional[int] = None) -> SuperstepRecord:
    """Decode one packed stats row into a typed record."""
    labels, explored, sweeps = (int(row[0]), int(row[1]), int(row[2]))
    return make_record(mode,
                       labels=None if labels < 0 else labels,
                       explored=None if explored < 0 else explored,
                       sweeps=None if sweeps < 0 else sweeps,
                       trees=trees)

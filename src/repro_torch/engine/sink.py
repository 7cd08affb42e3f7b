"""Emission sink — where a policy's committed labels land.

:class:`DenseSink` holds one padded ``LabelTable`` on the build's
device. Overflow accumulates on the device and is read at commit points
(every commit for an ``eager_stats`` policy, else once at the end of
the run), so the dispatch never waits on it mid-superstep.
"""

from __future__ import annotations

import torch

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelOverflowError, LabelTable


class DenseSink:
    """One dense ``LabelTable``."""

    def __init__(self, n: int, cap: int, device):
        self.n = int(n)
        self.cap = int(cap)
        self._table = lbl.empty(self.n, self.cap, device)
        self._ovf = torch.zeros((), dtype=torch.bool, device=device)

    def insert(self, roots: torch.Tensor, emit: torch.Tensor,
               dist: torch.Tensor) -> None:
        self._table, ovf = lbl.insert_batch(self._table, roots, emit, dist)
        self._ovf |= ovf

    def note_overflow(self, flag: torch.Tensor) -> None:
        """Fold in an overflow verdict from outside the sink (GLL's
        local table)."""
        self._ovf |= flag

    def table(self) -> LabelTable:
        return self._table

    def overflowed(self) -> bool:
        return bool(self._ovf)          # one host sync

    def raise_on_overflow(self) -> None:
        if self.overflowed():
            raise LabelOverflowError(self.cap)

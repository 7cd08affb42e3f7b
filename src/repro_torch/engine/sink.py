"""Emission sink — where a policy's committed labels land.

:class:`DenseSink` holds one padded ``LabelTable`` on the build's
device. Overflow accumulates on the device and is read at commit points
(every commit for an ``eager_stats`` policy or a checkpointed run, else
once at the end of the run), so the dispatch never waits on it
mid-superstep.

The sink also carries the checkpoint protocol (``meta`` /
``state_arrays`` / ``load_state``), with the reference's keys and
metadata, which is how every algorithm checkpoints and resumes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelOverflowError, LabelTable

#: the one channel of an undirected build (directed builds, ROADMAP
#: item 8, add "out"/"in")
CHANNEL = "labels"


def _pad_table_arrays(hubs: torch.Tensor, dist: torch.Tensor,
                      cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Widen restored ``[..., L_saved]`` label arrays to ``cap`` with
    ``(-1, +inf)``: the regrow-resume path (a checkpoint written under a
    smaller cap stays usable after ``build`` grows the capacity)."""
    have = hubs.shape[-1]
    if have > cap:
        raise ValueError(f"cannot shrink label arrays {have} -> {cap}")
    if have == cap:
        return hubs, dist
    pad = cap - have
    return (torch.nn.functional.pad(hubs, (0, pad), value=-1),
            torch.nn.functional.pad(dist, (0, pad), value=torch.inf))


class DenseSink:
    """One dense ``LabelTable``."""

    kind = "dense"

    def __init__(self, n: int, cap: int, device):
        self.n = int(n)
        self.cap = int(cap)
        self.device = torch.device(device)
        self._table = lbl.empty(self.n, self.cap, self.device)
        self._ovf = torch.zeros((), dtype=torch.bool, device=self.device)

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

    # --------------------------------------------- checkpoint payload

    def meta(self) -> dict:
        return {"kind": self.kind, "cap": self.cap, "n": self.n,
                "channels": [CHANNEL]}

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """The table's tensors, on the sink's device; the checkpoint
        manager copies them to the host before it writes."""
        t = self._table
        return {f"{CHANNEL}_hubs": t.hubs, f"{CHANNEL}_dist": t.dist,
                f"{CHANNEL}_count": t.count}

    def load_state(self, arrays) -> None:
        """Adopt restored arrays (tensors or numpy), padded to this
        sink's cap."""
        def get(key, dtype):
            return torch.as_tensor(arrays[f"{CHANNEL}_{key}"], dtype=dtype,
                                   device=self.device)
        hubs, dist = _pad_table_arrays(get("hubs", torch.int32),
                                       get("dist", torch.float32), self.cap)
        self._table = LabelTable(hubs.contiguous(), dist.contiguous(),
                                 get("count", torch.int32))

"""Emission sinks — where a policy's committed labels land.

- :class:`DenseSink` holds one padded ``LabelTable`` per channel on the
  build's device (undirected builds: ``"labels"``; directed builds:
  ``"out"`` and ``"in"``). Overflow, shared by the channels,
  accumulates on the device and is read at commit points (every commit
  for an ``eager_stats`` policy or a checkpointed run, else once at the
  end of the run), so the dispatch never waits on it mid-superstep.
- :class:`MeshTableSink` holds the distributed builds' hub-partitioned
  label tables, one ``[n, cap]`` table a node on the node's device
  (the reference's ``[q, n, cap]`` table sharded by node);
- :class:`StreamingShardSink` hub-partitions each commit's emissions
  straight into per-shard host arrays
  (`repro_torch.parallel.ShardAccumulator`): the dense ``[n, cap]``
  table never exists, per-shard caps regrow independently and overflow
  cannot happen.

Both carry the checkpoint protocol (``meta`` / ``state_arrays`` /
``load_state``) with the reference's keys and metadata, which is how
every algorithm checkpoints and resumes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelOverflowError, LabelTable
from repro_torch.parallel.sharding import ShardAccumulator

#: the one channel of an undirected build
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
    """One dense ``LabelTable`` per channel."""

    kind = "dense"

    def __init__(self, n: int, cap: int, device,
                 channels: Sequence[str] = (CHANNEL,)):
        self.n = int(n)
        self.cap = int(cap)
        self.device = torch.device(device)
        self.channels = tuple(channels)
        self._tables: Dict[str, LabelTable] = {
            ch: lbl.empty(self.n, self.cap, self.device)
            for ch in self.channels}
        self._ovf = torch.zeros((), dtype=torch.bool, device=self.device)

    def insert(self, roots: torch.Tensor, emit: torch.Tensor,
               dist: torch.Tensor, channel: Optional[str] = None) -> None:
        ch = channel or self.channels[0]
        self._tables[ch], ovf = lbl.insert_batch(self._tables[ch], roots,
                                                 emit, dist)
        self._ovf |= ovf

    def note_overflow(self, flag: torch.Tensor) -> None:
        """Fold in an overflow verdict from outside the sink (GLL's
        local table)."""
        self._ovf |= flag

    def table(self, channel: Optional[str] = None) -> LabelTable:
        return self._tables[channel or self.channels[0]]

    def overflowed(self) -> bool:
        return bool(self._ovf)          # one host sync

    def raise_on_overflow(self) -> None:
        if self.overflowed():
            raise LabelOverflowError(self.cap)

    # --------------------------------------------- checkpoint payload

    def meta(self) -> dict:
        return {"kind": self.kind, "cap": self.cap, "n": self.n,
                "channels": list(self.channels)}

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """Each channel's tensors, on the sink's device; the checkpoint
        manager copies them to the host before it writes."""
        out: Dict[str, torch.Tensor] = {}
        for ch, t in self._tables.items():
            out[f"{ch}_hubs"] = t.hubs
            out[f"{ch}_dist"] = t.dist
            out[f"{ch}_count"] = t.count
        return out

    def load_state(self, arrays) -> None:
        """Adopt restored arrays (tensors or numpy), padded to this
        sink's cap."""
        def get(key, dtype):
            return torch.as_tensor(arrays[key], dtype=dtype,
                                   device=self.device)
        for ch in self.channels:
            hubs, dist = _pad_table_arrays(get(f"{ch}_hubs", torch.int32),
                                           get(f"{ch}_dist", torch.float32),
                                           self.cap)
            self._tables[ch] = LabelTable(hubs.contiguous(),
                                          dist.contiguous(),
                                          get(f"{ch}_count", torch.int32))


class StreamingShardSink:
    """Hub-partitioned streaming residency: never a dense table.

    Each insert fetches its emission planes to the host once and appends
    every tree's labels to its hub's shard. Per-shard caps regrow
    geometrically, so there is no ``LabelOverflowError`` on this path.
    """

    kind = "sharded"

    def __init__(self, n: int, rank: np.ndarray, num_shards: int):
        self.n = int(n)
        self.cap = None                 # no fixed cap on this path
        self.acc = ShardAccumulator(n, rank, num_shards)
        self.num_shards = self.acc.num_shards

    def insert(self, roots: torch.Tensor, emit: torch.Tensor,
               dist: torch.Tensor, channel: Optional[str] = None) -> None:
        """Padding trees emit nothing (the policies mask them), so every
        row is taken as valid."""
        if channel not in (None, CHANNEL):
            raise ValueError(f"a sharded sink has one channel, not "
                             f"{channel!r}")
        roots_h = roots.cpu().numpy()
        self.acc.insert(roots_h, np.ones(len(roots_h), bool),
                        emit.cpu().numpy(), dist.cpu().numpy())

    def note_overflow(self, flag) -> None:
        del flag                        # shard caps regrow; nothing to do

    def overflowed(self) -> bool:
        return False

    def raise_on_overflow(self) -> None:
        return None

    def shard_arrays(self):
        return self.acc.shard_arrays()

    @property
    def total_labels(self) -> int:
        return self.acc.total_labels

    # --------------------------------------------- checkpoint payload

    def meta(self) -> dict:
        return {"kind": self.kind, "cap": None, "n": self.n,
                "shards": self.num_shards}

    def state_arrays(self) -> Dict[str, np.ndarray]:
        return self.acc.state_arrays()

    def load_state(self, arrays) -> None:
        self.acc.load_state(arrays)


class MeshTableSink:
    """The distributed builds' hub-partitioned tables: node ``i``'s
    ``[n, cap]`` table on ``mesh.devices[i]``.

    The policy's superstep inserts into the nodes' tables and hands them
    back through :meth:`set_table`; the sink owns placement, the
    overflow verdict and the checkpoint payload, whose arrays are the
    reference's ``[q, n, cap]`` stack.
    """

    kind = "mesh"

    def __init__(self, mesh, n: int, cap: int):
        self.mesh = mesh
        self.n = int(n)
        self.cap = int(cap)
        self.q = mesh.q
        # distinct tensors per node, even where nodes share a device
        self.tables: List[LabelTable] = [lbl.empty(self.n, self.cap, d)
                                         for d in mesh.devices]
        self._host_ovf = False

    def set_table(self, tables: Sequence[LabelTable]) -> None:
        self.tables = list(tables)

    def note_overflow(self, flag: bool) -> None:
        self._host_ovf = self._host_ovf or bool(flag)

    def overflowed(self) -> bool:
        return self._host_ovf

    def raise_on_overflow(self) -> None:
        if self._host_ovf:
            raise LabelOverflowError(self.cap)

    # --------------------------------------------- checkpoint payload

    def meta(self) -> dict:
        return {"kind": self.kind, "cap": self.cap, "n": self.n,
                "q": self.q}

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """The ``[q, n, cap]`` hubs/dist and ``[q, n]`` counts, stacked
        on the host (the manager writes them from there)."""
        return {f: torch.stack([getattr(t, f).cpu() for t in self.tables])
                for f in ("hubs", "dist", "count")}

    def load_state(self, arrays) -> None:
        """Adopt restored ``[q, n, L]`` arrays, padded to this sink's
        cap, one node's slice to each node's device."""
        hubs, dist = _pad_table_arrays(
            torch.as_tensor(np.asarray(arrays["hubs"]), dtype=torch.int32),
            torch.as_tensor(np.asarray(arrays["dist"]),
                            dtype=torch.float32), self.cap)
        count = torch.as_tensor(np.asarray(arrays["count"]),
                                dtype=torch.int32)
        self.tables = [LabelTable(hubs[i].to(d).contiguous(),
                                  dist[i].to(d).contiguous(),
                                  count[i].to(d).contiguous())
                       for i, d in enumerate(self.mesh.devices)]

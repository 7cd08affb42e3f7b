"""`DenseStore` — one label table resident on one device.

Queries intersect the endpoints' label rows through
`repro_torch.kernels.label_query.query_table`: one launch of the
hand-written kernel, which reads the rows from the table, when the
table is on the card; the plain version on the CPU.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike
from repro_torch.kernels.label_query import query_table


def as_index(x, device) -> torch.Tensor:
    """Vertex ids (array-like or tensor, any int dtype) as a 1-D int64
    tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.atleast_1d(np.asarray(x)).astype(np.int64))
    return x.reshape(-1).to(device=device, dtype=torch.int64)


class DenseStore:
    kind = "dense"

    def __init__(self, table: LabelTable):
        """Raises ValueError on a table whose padding breaks the query
        kernel's contract (`labels.check_padding`)."""
        lbl.check_padding(table)
        self._table = table

    @property
    def device(self) -> torch.device:
        return self._table.hubs.device

    @property
    def n(self) -> int:
        return self._table.n

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def total_labels(self) -> int:
        return lbl.total_labels(self._table)

    def query_device(self, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dist, hub) as tensors on the store's device."""
        return query_table(self._table, as_index(u, self.device),
                           as_index(v, self.device))

    def query(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_device(u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    # The store protocol's per-shard half, as the reference's DenseStore
    # has it: serving routes only a multi-shard store, so on a dense
    # store these are called by the parity tests alone.
    def shard_counts(self) -> np.ndarray:
        """``[1, n]`` label counts (routing degenerates for one shard)."""
        return self._table.count.cpu().numpy()[None]

    def query_shard_device(self, k: int, u, v
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        if k != 0:
            raise IndexError(f"dense store has one shard, not {k + 1}")
        return self.query_device(u, v)

    def query_shard(self, k: int, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_shard_device(k, u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    def to_table(self) -> LabelTable:
        return self._table

    def label_bytes(self) -> int:
        """Bytes of the (hub, dist) pairs present, 8 a label."""
        return self.total_labels * 8

    def shard_arrays(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        t = self._table
        yield 0, {"hubs": t.hubs.cpu().numpy(),
                  "dist": t.dist.cpu().numpy(),
                  "count": t.count.cpu().numpy()}

    @classmethod
    def from_shard_arrays(cls, shards, device: DeviceLike = None
                          ) -> "DenseStore":
        """Merge per-shard host ``{hubs, dist, count}`` dicts into one
        table on ``device`` (default: the card): each row's shard slots
        concatenated in shard order, the valid ones first, trimmed to
        the tight cap (as the reference merges them)."""
        shards = list(shards)
        if len(shards) == 1:
            s = shards[0]
            return cls(interop.label_table(s["hubs"], s["dist"], s["count"],
                                           device))
        h2 = np.concatenate([np.asarray(s["hubs"]) for s in shards], axis=1)
        d2 = np.concatenate([np.asarray(s["dist"]) for s in shards], axis=1)
        valid = h2 >= 0
        order = np.argsort(~valid, axis=1, kind="stable")  # keepers first
        h2 = np.take_along_axis(h2, order, axis=1)
        d2 = np.take_along_axis(d2, order, axis=1)
        count = valid.sum(axis=1).astype(np.int32)
        cap = int(max(1, count.max()))
        return cls(interop.label_table(h2[:, :cap], d2[:, :cap], count,
                                       device))

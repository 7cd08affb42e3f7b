"""`ShardedStore` — labels partitioned by hub rank into K shards.

The paper's §5.1 partitioning as the store's own layout: shard ``k``
holds, for every vertex, exactly the labels whose hub it owns
(``order_index(hub) mod K``). A PPSD query is K per-shard partial
intersections plus one cross-shard ``min``: exact, because every common
hub of a pair is intersected in exactly one shard and the f32 ``min`` is
order-insensitive.

The stacked ``[K, n, Ls]`` tensors live on the index's device. On the
card a query is K launches of the hand-written ``label_query`` kernel,
one over each shard's ``[n, Ls]`` view, then one ``torch.min`` over the
shard axis (whose first-index rule picks the lowest shard on a tie, as
the reference's ``argmin`` does) and a gather of the winning shard's
hub; on the CPU the plain query per shard. :meth:`as_partitioned`
places shard ``k`` on node ``k`` of a node mesh, so QFDL serves from the
store's own layout.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index.store.dense import DenseStore, as_index
from repro_torch.kernels.label_query import query_table
from repro_torch.parallel.sharding import hub_partition_arrays


class ShardedStore:
    kind = "sharded"

    def __init__(self, hubs: torch.Tensor, dist: torch.Tensor,
                 count: torch.Tensor):
        """``hubs`` i32 / ``dist`` f32 [K, n, Ls] and ``count`` i32
        [K, n] on one device: shard-major stacked label arrays. Raises
        ValueError when a shard breaks the query kernel's padding
        contract (`labels.check_padding`)."""
        if hubs.dim() != 3 or count.dim() != 2:
            raise ValueError("ShardedStore wants [K, n, Ls] labels and "
                             "[K, n] counts")
        self.hubs = hubs.contiguous()
        self.dist = dist.contiguous()
        self.count = count.contiguous()
        # per-shard [n, Ls] views (contiguous slices, no copy)
        self._views = [LabelTable(self.hubs[k], self.dist[k], self.count[k])
                       for k in range(self.num_shards)]
        for t in self._views:
            lbl.check_padding(t)

    # ---------------------------------------------------- protocol

    @property
    def device(self) -> torch.device:
        return self.hubs.device

    @property
    def n(self) -> int:
        return self.hubs.shape[1]

    @property
    def num_shards(self) -> int:
        return self.hubs.shape[0]

    @property
    def shard_cap(self) -> int:
        return self.hubs.shape[2]

    @property
    def total_labels(self) -> int:
        return int(self.count.sum())

    def query_device(self, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full K-shard reduction, on the store's device: K partial
        queries, then the least distance over the shards (the lowest
        shard on a tie) and its shard's hub, ``-1`` where no shard holds
        a common hub."""
        u, v = as_index(u, self.device), as_index(v, self.device)
        parts = [query_table(t, u, v) for t in self._views]
        ds = torch.stack([d for d, _ in parts])              # [K, Q]
        hs = torch.stack([h for _, h in parts])
        best, k = torch.min(ds, dim=0)
        hub = torch.gather(hs, 0, k[None, :])[0]
        return best, torch.where(torch.isfinite(best), hub, -1)

    def query(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_device(u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    def shard_counts(self) -> np.ndarray:
        """Host ``[K, n]`` per-shard label counts: the routing table
        (shard k can answer ``(u, v)`` only when both endpoints hold
        labels in it)."""
        return self.count.cpu().numpy()

    def shard_table(self, k: int) -> LabelTable:
        """Shard ``k``'s ``[n, Ls]`` tables (views, no copy)."""
        return self._views[k]

    def query_shard_device(self, k: int, u, v
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Partial PPSD over shard ``k`` only, on the store's device
        (+inf / -1 where shard k holds no common hub)."""
        return query_table(self._views[k], as_index(u, self.device),
                           as_index(v, self.device))

    def query_shard(self, k: int, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_shard_device(k, u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    def to_table(self) -> LabelTable:
        return DenseStore.from_shard_arrays(
            (arrs for _, arrs in self.shard_arrays()),
            device=self.device).to_table()

    def shard_arrays(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Per-shard host arrays, each trimmed to its own tight cap (a
        shard file does not pay the widest shard's padding)."""
        count = self.count.cpu().numpy()
        for k in range(self.num_shards):
            cap = int(max(1, count[k].max()))
            yield k, {"hubs": self.hubs[k, :, :cap].cpu().numpy(),
                      "dist": self.dist[k, :, :cap].cpu().numpy(),
                      "count": count[k]}

    def label_bytes(self) -> int:
        return self.total_labels * 8

    def shard_label_bytes(self) -> list:
        """Per-shard resident label bytes."""
        return [int(c) * 8 for c in self.count.sum(dim=1).tolist()]

    def as_partitioned(self, mesh) -> List[LabelTable]:
        """The shards as QFDL's per-node partitions: shard ``k`` on node
        ``k``'s device (views where it is the store's device); needs
        ``mesh.q == num_shards``."""
        if mesh.q != self.num_shards:
            raise ValueError(f"mesh has {mesh.q} nodes but the store has "
                             f"{self.num_shards} shards")
        return [LabelTable(*(x.to(d) for x in t))
                for t, d in zip(self._views, mesh.devices)]

    # ------------------------------------------------- constructors

    @classmethod
    def from_table(cls, table: LabelTable, rank: np.ndarray,
                   num_shards: int) -> "ShardedStore":
        """Partition a dense table by hub ownership, on its device."""
        h, d, c = hub_partition_arrays(table.hubs.cpu().numpy(),
                                       table.dist.cpu().numpy(), rank,
                                       num_shards)
        return cls._on(h, d, c, table.hubs.device)

    @classmethod
    def from_accumulator(cls, acc, device: DeviceLike = None
                         ) -> "ShardedStore":
        """Adopt a streamed hub partition (`ShardAccumulator`) without
        ever forming the dense table; per-shard caps stay tight."""
        return cls.from_shard_arrays(
            (arrs for _, arrs in acc.shard_arrays()), device=device)

    @classmethod
    def from_shard_arrays(cls, shards, device: DeviceLike = None
                          ) -> "ShardedStore":
        """Stack per-shard host ``{hubs, dist, count}`` dicts on
        ``device`` (default: the card); ragged per-shard caps are padded
        to the widest with ``(-1, +inf)``."""
        shards = list(shards)
        Ls = max([1] + [np.asarray(s["hubs"]).shape[1] for s in shards])
        hubs, dist, count = [], [], []
        for s in shards:
            h = np.asarray(s["hubs"])
            d = np.asarray(s["dist"])
            pad = Ls - h.shape[1]
            if pad:
                h = np.pad(h, ((0, 0), (0, pad)), constant_values=-1)
                d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
            hubs.append(h)
            dist.append(d)
            count.append(np.asarray(s["count"]))
        return cls._on(np.stack(hubs), np.stack(dist), np.stack(count),
                       resolve_device(device))

    @classmethod
    def _on(cls, hubs, dist, count, device) -> "ShardedStore":
        return cls(torch.as_tensor(np.asarray(hubs, np.int32), device=device),
                   torch.as_tensor(np.asarray(dist, np.float32),
                                   device=device),
                   torch.as_tensor(np.asarray(count, np.int32), device=device))

"""`LabelStore` — the label-residency protocol behind ``CHLIndex``.

Everything outside ``index/store/`` (artifact save/load, serving) talks
to this protocol, never to a backend's internal arrays, and dtype
conversion of label arrays happens only in ``index/quant/`` and
``index/store/``. The backends, as in the reference:

- :class:`~repro_torch.index.store.dense.DenseStore`: one table;
- :class:`~repro_torch.index.store.sharded.ShardedStore`: K hub shards;
- :class:`~repro_torch.index.store.spill.SpillStore`: memory-mapped
  shard files on the host, each query's rows intersected on the device;
- :class:`~repro_torch.index.store.compressed.CompressedStore`: encoded
  hub deltas and distance codes on the device, decoded per query.
"""

from __future__ import annotations

from typing import Dict, Iterator, Protocol, Tuple

import numpy as np


class CorruptArtifactError(ValueError):
    """An on-disk index artifact fails integrity verification —
    checksum mismatch, truncated shard npz, label counts that contradict
    the manifest. Subclasses ``ValueError``; catch it to tell corruption
    from misuse (wrong rank, wrong store kind)."""


#: residencies ``CHLIndex.load(store=...)`` may request
LOAD_STORE_KINDS = ("dense", "sharded", "spill", "compressed")


class LabelStore(Protocol):
    """What ``CHLIndex`` and ``repro_torch.serve`` require of a store."""

    kind: str

    @property
    def n(self) -> int:
        ...

    @property
    def num_shards(self) -> int:
        ...

    @property
    def total_labels(self) -> int:
        ...

    def query(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        """Batched PPSD: (distance f32 [Q], witnessing hub i32 [Q];
        +inf / -1 when the label sets are disjoint)."""
        ...

    def shard_counts(self) -> np.ndarray:
        """Host ``[K, n]`` per-shard label counts (the routing table)."""
        ...

    def query_shard_device(self, k: int, u, v):
        """Partial PPSD over shard ``k`` as tensors on the store's
        device (+inf / -1 where it holds no common hub)."""
        ...

    def to_table(self):
        ...

    def label_bytes(self) -> int:
        """Bytes to store the (hub, dist) pairs actually present."""
        ...

    def shard_arrays(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Yield ``(k, arrays)`` per shard as host arrays, one shard
        resident at a time — the save path. Dense, sharded and spill
        stores yield ``{"hubs", "dist", "count"}``; a compressed store
        its encoded ``{"dhub", "dcode", "count"}``."""
        ...


def shard_filename(k: int) -> str:
    """On-disk name of shard ``k`` of an artifact."""
    return f"shard_{k}.npz"

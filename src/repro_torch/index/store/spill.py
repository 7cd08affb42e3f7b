"""`SpillStore` — per-shard memory-mapped npz segments.

An index whose labels exceed host RAM still loads and serves: each
``shard_<k>.npz`` member is memory-mapped straight out of the
(uncompressed) zip archive, so only the label rows a query batch
touches are paged in. A shard query gathers those rows from the maps
on the host (numpy fancy indexing, a fresh array), copies them to the
store's device and intersects them there: on the card one launch of
the operand form of the hand-written ``label_query`` kernel, on the
CPU the plain version in chunks of the batch. Shards reduce as in the
reference: the least distance, the lowest shard on a tie.

``np.savez`` stores members uncompressed (ZIP_STORED), so a member is a
verbatim ``.npy`` file at a fixed offset inside the archive; the local
zip header and the npy header are parsed once and the data range goes
to ``np.memmap``. Compressed or exotic members fall back to a one-shot
``np.load`` of that shard. Truncated or missing shard files raise a
typed :class:`~repro_torch.index.store.base.CorruptArtifactError` (a
``ValueError``) naming the shard, and so does a mapped page that fails
at read time (the ``spill.query`` fault site sits in front of the
read).
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.inject import fault_site
from repro_torch.index.store.base import CorruptArtifactError, shard_filename
from repro_torch.index.store.dense import DenseStore
from repro_torch.kernels.label_query import query_rows


class _Unmappable(Exception):
    """Member can't be memory-mapped (compressed / unknown header) —
    fall back to eager np.load for that shard."""


def _npz_member_memmaps(path: str) -> Dict[str, np.memmap]:
    """Memory-map every member of an uncompressed ``.npz``."""
    out: Dict[str, np.memmap] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for zinfo in zf.infolist():
            if zinfo.compress_type != zipfile.ZIP_STORED:
                raise _Unmappable(zinfo.filename)
            key = zinfo.filename
            if key.endswith(".npy"):
                key = key[:-4]
            # local file header: 30 fixed bytes, name/extra lengths at
            # offsets 26/28 (they can differ from the central directory)
            f.seek(zinfo.header_offset)
            hdr = f.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                raise _Unmappable(zinfo.filename)
            name_len = int.from_bytes(hdr[26:28], "little")
            extra_len = int.from_bytes(hdr[28:30], "little")
            f.seek(zinfo.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            else:
                raise _Unmappable(zinfo.filename)
            if fortran:
                raise _Unmappable(zinfo.filename)
            out[key] = np.memmap(path, dtype=dtype, mode="r",
                                 shape=shape, offset=f.tell())
    return out


def open_npz_arrays(path: str, label: str) -> Dict[str, np.ndarray]:
    """Open an ``.npz`` as memmaps (eager fallback for compressed /
    exotic members); clear errors naming ``label`` for missing or
    corrupt files."""
    fault_site("artifact.load.shard", path=path)
    if not os.path.exists(path):
        raise CorruptArtifactError(
            f"missing shard file {label} — artifact is incomplete "
            "(copy interrupted?)")
    try:
        return _npz_member_memmaps(path)
    except _Unmappable:
        pass
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise CorruptArtifactError(
            f"shard file {label} is truncated or corrupt ({e})") from e
    try:
        with np.load(path) as z:
            return {name: z[name] for name in z.files}
    except Exception as e:
        raise CorruptArtifactError(
            f"shard file {label} is truncated or corrupt ({e})") from e


def open_shard(directory: str, k: int) -> Dict[str, np.ndarray]:
    """Open ``<directory>/shard_<k>.npz`` lazily (see
    :func:`open_npz_arrays`)."""
    path = os.path.join(directory, shard_filename(k))
    return open_npz_arrays(path, path)


def _host_ids(x) -> np.ndarray:
    """Vertex ids (array-like or tensor) as a 1-D host int64 array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.atleast_1d(np.asarray(x)).astype(np.int64).reshape(-1)


class SpillStore:
    kind = "spill"

    def __init__(self, shards: List[Dict[str, np.ndarray]],
                 device: DeviceLike = None):
        """``shards``: per-shard ``{hubs, dist, count}`` with hubs/dist
        typically ``np.memmap`` views (`open_shard` builds them); the labels
        stay mapped on the host and each query's rows are intersected
        on ``device`` (default: the card; raises without CUDA)."""
        if not shards:
            raise ValueError("SpillStore needs at least one shard")
        self._device = resolve_device(device)
        self._shards = shards
        # counts are [n] i32 — small; materialize for totals
        self._counts = [np.asarray(s["count"]) for s in shards]

    # ---------------------------------------------------- protocol

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n(self) -> int:
        return self._shards[0]["hubs"].shape[0]

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def total_labels(self) -> int:
        return int(sum(int(c.sum()) for c in self._counts))

    def gather_rows(self, k: int, u, v) -> Tuple[np.ndarray, ...]:
        """Shard ``k``'s rows of the endpoints, gathered from the maps on
        the host into fresh arrays: ``(hubs_u, dist_u, hubs_v, dist_v)``,
        i32 / f32 ``[Q, Ls]``. The ``spill.query`` fault site precedes
        the read, and a mapped page that fails raises
        :class:`CorruptArtifactError` naming the shard."""
        fault_site("spill.query")
        s = self._shards[k]
        u, v = _host_ids(u), _host_ids(v)
        try:
            return (np.asarray(s["hubs"][u], np.int32),
                    np.asarray(s["dist"][u], np.float32),
                    np.asarray(s["hubs"][v], np.int32),
                    np.asarray(s["dist"][v], np.float32))
        except OSError as e:
            # a mapped page whose backing file went bad faults at read
            # time, not open time — surface it typed so the routing
            # tier can quarantine this shard
            raise CorruptArtifactError(
                f"spill shard {k} failed during a mapped read "
                f"({e})") from e

    def query_shard_device(self, k: int, u, v
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Partial PPSD over shard ``k`` only, as tensors on the store's
        device (+inf / -1 where it holds no common hub): the touched rows
        gathered on the host, copied, then intersected (per-shard routing
        pages in only the shards owning the endpoints' hubs)."""
        rows = [torch.from_numpy(a).to(self._device)
                for a in self.gather_rows(k, u, v)]
        return query_rows(*rows)

    def query_shard(self, k: int, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_shard_device(k, u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    def query_device(self, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full K-shard reduction on the store's device: the least
        distance over the shards (the lowest shard on a tie) and its
        hub."""
        u, v = _host_ids(u), _host_ids(v)
        best = torch.full((len(u),), torch.inf, dtype=torch.float32,
                          device=self._device)
        hub = torch.full((len(u),), -1, dtype=torch.int32,
                         device=self._device)
        for k in range(self.num_shards):
            d, h = self.query_shard_device(k, u, v)
            take = d < best
            hub = torch.where(take, h, hub)
            best = torch.where(take, d, best)
        return best, hub

    def query(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_device(u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    def shard_counts(self) -> np.ndarray:
        """Host ``[K, n]`` per-shard label counts (already resident —
        counts are the only arrays a spill store materializes)."""
        return np.stack(self._counts)

    def to_table(self) -> LabelTable:
        """Materializes everything on the store's device — O(total label
        slots) memory; offline analysis only, never the serving path."""
        return DenseStore.from_shard_arrays(
            (arrs for _, arrs in self.shard_arrays()),
            device=self._device).to_table()

    def shard_arrays(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        for k, s in enumerate(self._shards):
            yield k, {"hubs": s["hubs"], "dist": s["dist"],
                      "count": self._counts[k]}

    def label_bytes(self) -> int:
        return self.total_labels * 8

    def resident_bytes(self) -> int:
        """Host bytes held eagerly (counts only — labels stay mapped)."""
        return int(sum(c.nbytes for c in self._counts))

    def is_mapped(self) -> bool:
        """True when every shard's label arrays are memory-mapped."""
        return all(isinstance(s["hubs"], np.memmap)
                   and isinstance(s["dist"], np.memmap)
                   for s in self._shards)

"""`CompressedStore` — quantized label residency behind the
``LabelStore`` protocol.

Labels live on the device in their *encoded* form: hub ids as
first-order deltas of canonical order indices
(``repro_torch.index.quant.deltas``, u8/u16/u32) and distances under a
distance codec (``repro_torch.index.quant.codecs``, bf16 or fixed-point
u16/u32 against a per-shard scale). A query gathers only the touched
rows, decodes them to f32 on the device and intersects them: on the
card one launch of the operand form of the hand-written ``label_query``
kernel a shard, on the CPU the plain version. Narrow bytes at rest,
f32 arithmetic always: at 1 byte of hub delta and 2 of distance code a
label costs 3 bytes instead of the dense 8.

A u16/u32 stream is held on the device as the int16/int32 tensor of the
same bits and widened right after the row gather; no arithmetic runs in
an unsigned dtype. ``dtypes()``, ``manifest_info()`` and the arrays
``shard_arrays()`` yields carry the storage dtypes (``uint8``,
``uint16``, ``uint32``), so manifests and shard files are the
reference package's.

Exactness: in the codec's exact mode decoded distances equal the f32
originals bit for bit, and sorting a row by order index only permutes
the terms of an order-insensitive f32 min, so every distance equals
the dense store's. The witness hub is the first attaining slot of the
*sorted* row (the reference's rule), which can differ from a dense
store's hub where several hubs attain the minimum. Lossy mode reports
the measured max ulp error (``max_ulp_err``).

Shards follow §5.1 hub ownership like
:class:`~repro_torch.index.store.sharded.ShardedStore`, each with its
own cap, delta dtype and scale, so they are a list, not a stack.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.inject import fault_site
from repro_torch.index.quant import (code_array, code_tensor,
                                     decode_dist_np, decode_dist_torch,
                                     delta_decode_rows_np,
                                     delta_decode_rows_torch,
                                     delta_encode_rows, encode_dist,
                                     order_permutation)
from repro_torch.index.store.base import CorruptArtifactError
from repro_torch.index.store.dense import DenseStore, as_index
from repro_torch.kernels.label_query import query_rows

#: npz member names of one encoded shard (the on-disk v3 layout)
ENCODED_KEYS = ("dhub", "dcode", "count")


class CompressedStore:
    kind = "compressed"

    def __init__(self, shards: List[Dict[str, np.ndarray]],
                 order: np.ndarray, *, codec: str, exact: bool,
                 scales: List[float], max_ulp_err: int = 0,
                 device: DeviceLike = None):
        """``shards``: per-shard encoded host ``{dhub, dcode, count}``;
        ``order``: rank-descending vertex order (position -> vertex);
        ``scales``: per-shard fixed-point scales (1.0 under bf16). The
        encoded arrays go to ``device`` (default: the card)."""
        if not shards:
            raise ValueError("CompressedStore needs at least one shard")
        if len(scales) != len(shards):
            raise ValueError("one scale per shard required")
        dev = resolve_device(device)
        self.codec = codec
        self.exact = exact
        self.scales = [float(s) for s in scales]
        self.max_ulp_err = int(max_ulp_err)
        self._order_np = np.asarray(order, np.int32)
        self._order = torch.from_numpy(self._order_np.copy()).to(dev)
        self._dhub_dtypes = [np.asarray(s["dhub"]).dtype for s in shards]
        self._dcode_dtype = np.asarray(shards[0]["dcode"]).dtype
        self._counts = [np.array(s["count"], np.int32) for s in shards]
        self._shards = [{"dhub": code_tensor(s["dhub"], dev),
                         "dcode": code_tensor(s["dcode"], dev),
                         "count": torch.from_numpy(c.copy()).to(dev)}
                        for s, c in zip(shards, self._counts)]

    # ---------------------------------------------------- protocol

    @property
    def device(self) -> torch.device:
        return self._order.device

    @property
    def n(self) -> int:
        return int(self._shards[0]["dhub"].shape[0])

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def total_labels(self) -> int:
        return int(sum(int(c.sum()) for c in self._counts))

    def decode_rows(self, k: int, ids: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard ``k``'s rows at ``ids`` (an index tensor on the store's
        device), gathered and decoded on the device: hub ids i32 and
        distances f32 ``[Q, Ls]``, ``(-1, +inf)`` past each count."""
        s = self._shards[k]
        hubs = delta_decode_rows_torch(s["dhub"][ids], s["count"][ids],
                                       self._order)
        dist = decode_dist_torch(s["dcode"][ids], self.codec,
                                 self.scales[k])
        return hubs, dist

    def query_shard_device(self, k: int, u, v
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Partial PPSD over shard ``k`` only, on the store's device:
        gather the touched rows, decode them, intersect (the routed
        serving path)."""
        hu, du = self.decode_rows(k, as_index(u, self.device))
        hv, dv = self.decode_rows(k, as_index(v, self.device))
        return query_rows(hu, du, hv, dv)

    def query_shard(self, k: int, u, v) -> Tuple[np.ndarray, np.ndarray]:
        d, h = self.query_shard_device(k, u, v)
        return d.cpu().numpy(), h.cpu().numpy()

    def query_device(self, u, v) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full cross-shard reduction on the store's device — exact for
        the same reason as the sharded store (disjoint hub ownership;
        f32 min is order-insensitive); the lowest shard wins a tie."""
        u, v = as_index(u, self.device), as_index(v, self.device)
        best = torch.full(u.shape, torch.inf, dtype=torch.float32,
                          device=self.device)
        hub = torch.full(u.shape, -1, dtype=torch.int32, device=self.device)
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
        """Host ``[K, n]`` per-shard label counts — the routing table."""
        return np.stack(self._counts)

    def to_table(self) -> LabelTable:
        """Dense f32 table on the store's device (decodes every shard —
        O(total label slots) memory; analysis and re-homing)."""
        return DenseStore.from_shard_arrays(
            (arrs for _, arrs in self.decoded_shard_arrays()),
            device=self.device).to_table()

    def shard_arrays(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Yield the **encoded** per-shard host arrays (``dhub``/``dcode``/
        ``count``, in their storage dtypes) — what the v3 artifact
        persists and checksums. For the decoded f32 view use
        :meth:`decoded_shard_arrays`."""
        for k, s in enumerate(self._shards):
            yield k, {"dhub": code_array(s["dhub"], self._dhub_dtypes[k]),
                      "dcode": code_array(s["dcode"], self._dcode_dtype),
                      "count": self._counts[k]}

    def decoded_shard_arrays(self
                             ) -> Iterator[Tuple[int,
                                                 Dict[str, np.ndarray]]]:
        """Per-shard dequantized host ``{hubs, dist, count}`` (one shard
        resident at a time) — the re-homing/merge view."""
        for k, arrs in self.shard_arrays():
            hubs = delta_decode_rows_np(arrs["dhub"], arrs["count"],
                                        self._order_np)
            dist = np.where(hubs >= 0,
                            decode_dist_np(arrs["dcode"], self.codec,
                                           self.scales[k]),
                            np.float32(np.inf))
            yield k, {"hubs": hubs, "dist": dist.astype(np.float32),
                      "count": arrs["count"]}

    def label_bytes(self) -> int:
        """Bytes of the encoded labels actually present."""
        return sum(self.shard_label_bytes())

    def shard_label_bytes(self) -> list:
        per = [dt.itemsize + self._dcode_dtype.itemsize
               for dt in self._dhub_dtypes]
        return [int(c.sum()) * p for c, p in zip(self._counts, per)]

    def dtypes(self) -> dict:
        """Storage dtypes per stream (``dhub`` varies per shard)."""
        return {"dhub": [str(dt) for dt in self._dhub_dtypes],
                "dcode": str(self._dcode_dtype)}

    def manifest_info(self) -> dict:
        """Codec fields of the v3 manifest ``store`` section."""
        return {"codec": self.codec, "exact": self.exact,
                "scale": self.scales, "dtype": self.dtypes(),
                "max_ulp_err": self.max_ulp_err}

    # ------------------------------------------------- constructors

    @classmethod
    def from_table(cls, table: LabelTable, rank: np.ndarray, *,
                   codec: str = "bf16", exact: bool = False,
                   shards: Optional[int] = None,
                   device: DeviceLike = None) -> "CompressedStore":
        """Encode a dense table, hub-partitioned into ``shards`` (§5.1
        ownership; default 1), onto ``device`` (default: the table's)."""
        from repro_torch.parallel.sharding import hub_partition_arrays
        K = shards or 1
        hubs = table.hubs.cpu().numpy()
        dist = table.dist.cpu().numpy()
        if K == 1:
            src = [{"hubs": hubs, "dist": dist,
                    "count": table.count.cpu().numpy()}]
        else:
            h, d, c = hub_partition_arrays(hubs, dist, rank, K)
            src = [{"hubs": h[k], "dist": d[k], "count": c[k]}
                   for k in range(K)]
        return cls._encode(src, rank, codec=codec, exact=exact,
                           device=device or table.hubs.device)

    @classmethod
    def from_store(cls, store, rank: np.ndarray, *,
                   codec: str = "bf16", exact: bool = False,
                   shards: Optional[int] = None,
                   device: DeviceLike = None) -> "CompressedStore":
        """Encode any loaded store onto ``device`` (default: the
        store's). The source's hub partitioning is kept when ``shards``
        matches (or is None); otherwise the labels are repartitioned
        through a dense merge."""
        device = device or store.device
        if shards is not None and shards != store.num_shards:
            return cls.from_table(store.to_table(), rank, codec=codec,
                                  exact=exact, shards=shards, device=device)
        if isinstance(store, CompressedStore):
            src = [arrs for _, arrs in store.decoded_shard_arrays()]
        elif store.num_shards == 1:
            return cls.from_table(store.to_table(), rank, codec=codec,
                                  exact=exact, shards=1, device=device)
        else:
            src = [dict(arrs) for _, arrs in store.shard_arrays()]
        return cls._encode(src, rank, codec=codec, exact=exact,
                           device=device)

    @classmethod
    def _encode(cls, src: List[Dict[str, np.ndarray]],
                rank: np.ndarray, *, codec: str, exact: bool,
                device: DeviceLike) -> "CompressedStore":
        order, oi = order_permutation(rank)
        shards, scales = [], []
        max_ulp = 0
        for s in src:
            fault_site("quant.encode.shard")
            deltas, dist_s, count = delta_encode_rows(
                s["hubs"], s["dist"], s["count"], oi)
            codes, scale, ulp = encode_dist(dist_s, codec, exact=exact)
            max_ulp = max(max_ulp, ulp)
            shards.append({"dhub": deltas, "dcode": codes,
                           "count": count})
            scales.append(scale)
        return cls(shards, order, codec=codec, exact=exact,
                   scales=scales, max_ulp_err=max_ulp, device=device)

    @classmethod
    def from_encoded_shards(cls, shards: List[Dict[str, np.ndarray]],
                            info: dict, rank: np.ndarray,
                            device: DeviceLike = None
                            ) -> "CompressedStore":
        """Adopt encoded shard arrays straight off a v3 artifact,
        validating cheap structural invariants (counts within caps,
        delta sums within the vertex range) so a tampered shard that
        slipped past the checksums still raises
        :class:`CorruptArtifactError`, not an index error mid-query."""
        order, _ = order_permutation(rank)
        n = len(order)
        checked = []
        for k, s in enumerate(shards):
            fault_site("quant.decode.shard")
            dhub = np.asarray(s["dhub"])
            dcode = np.asarray(s["dcode"])
            count = np.asarray(s["count"], np.int32)
            Ls = dhub.shape[1] if dhub.ndim == 2 else -1
            if dhub.shape != dcode.shape or Ls < 0 \
                    or len(count) != dhub.shape[0]:
                raise CorruptArtifactError(
                    f"compressed shard {k}: encoded array shapes "
                    f"disagree (dhub {dhub.shape}, dcode {dcode.shape},"
                    f" count {count.shape})")
            if count.min(initial=0) < 0 or count.max(initial=0) > Ls:
                raise CorruptArtifactError(
                    f"compressed shard {k}: label counts outside "
                    f"[0, {Ls}] (corrupt artifact)")
            # pad deltas are 0, so each row's delta sum is its last
            # order index — must stay inside the vertex range
            row_oi = dhub.astype(np.int64).sum(axis=1)
            if row_oi.size and int(row_oi.max()) >= n:
                raise CorruptArtifactError(
                    f"compressed shard {k}: decoded order index "
                    f"{int(row_oi.max())} out of range for n={n} "
                    "(corrupt artifact)")
            checked.append({"dhub": dhub, "dcode": dcode,
                            "count": count})
        scales = [float(x) for x in info.get("scale", [])] \
            or [1.0] * len(checked)
        return cls(checked, order, codec=info["codec"],
                   exact=bool(info.get("exact", False)), scales=scales,
                   max_ulp_err=int(info.get("max_ulp_err", 0)),
                   device=device)

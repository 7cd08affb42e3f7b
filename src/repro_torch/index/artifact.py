"""`CHLIndex` — the queryable, servable, persistable CHL artifact.

One object owns the outcome of a build: a label store (dense,
hub-sharded, memory-mapped or compressed; a directed index holds the
dense ``L_out``/``L_in`` pair instead), the plan that produced it, the
build report and the vertex hierarchy::

    idx = build(g, rank, BuildPlan(algo="plant"))
    idx.query(u, v)                  # batched PPSD distances
    srv = idx.serve(mode="qlsn")     # QueryService
    idx.save("run/index")            # on-disk artifact, format v3
    idx2 = CHLIndex.load("run/index", rank=rank)
    idx.apply(batch, graph=g)        # repair in place for a mutated graph

The on-disk format is the reference package's version 3, so artifacts
move between the two packages both ways::

    <dir>/manifest.json   {"format": "repro.index/chl", "version": 3,
                           "plan", "report", "rank_hash", "directed",
                           "n", "total_labels", "als",
                           "store": {"kind": "dense" | "sharded"
                                             | "compressed",
                                     "shards", "shard_labels",
                                     "shard_sha256",
                                     # compressed artifacts only:
                                     "codec", "exact", "scale",
                                     "dtype", "max_ulp_err"}}
    <dir>/rank.npy        the vertex hierarchy
    <dir>/shard_<k>.npz   hubs/dist/count of label shard k (a directed
                          index: out_*/in_* of its one shard; a
                          compressed one: the encoded dhub/dcode/count,
                          which the checksums cover)

Version-1 artifacts (one ``arrays.npz``) and version-2 artifacts (no
codec fields) load as the reference loads them, and a save migrates
them to version 3. Loads verify every shard file against its recorded
sha256 (unless ``verify=False``), the per-shard label counts and the
rank hash, and ``load(store=, shards=, codec=, quant_exact=)`` re-homes:
``"dense"`` merges the shards, ``"sharded"`` (re-)partitions by hub
rank, ``"spill"`` memory-maps the shard files (labels larger than host
RAM stay serveable), ``"compressed"`` encodes the labels through
``repro_torch.index.quant``. Writes go through a tmp dir and
``os.replace``: an overwrite never deletes the live artifact before the
replacement is staged; shard writes retry transient I/O and pass the
``artifact.save.shard`` / ``artifact.save.commit`` fault sites, shard
reads ``artifact.load.shard``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import weakref
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import interop
from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.inject import fault_site, with_retries
from repro_torch.index.plan import BuildPlan
from repro_torch.index.report import BuildReport
from repro_torch.index.store import (LOAD_STORE_KINDS, CompressedStore,
                                     CorruptArtifactError, DenseStore,
                                     LabelStore, ShardedStore, SpillStore,
                                     open_npz_arrays, open_shard,
                                     shard_filename)
from repro_torch.index.store.dense import as_index
from repro_torch.serve import backends
from repro_torch.serve.service import QueryService

FORMAT = "repro.index/chl"
VERSION = 3


def rank_hash(rank: np.ndarray) -> str:
    """Stable fingerprint of a vertex hierarchy."""
    r = np.ascontiguousarray(np.asarray(rank).astype(np.int64))
    return hashlib.sha256(r.tobytes()).hexdigest()


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    """Streaming sha256 of a file (bounded resident memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class CHLIndex:
    """A built Canonical Hub Labeling, packaged for serving.

    ``store`` (a :class:`~repro_torch.index.store.LabelStore`) holds the
    labels of an undirected graph; ``l_out``/``l_in`` those of a
    directed one (paper footnote 1's forward/backward labels, dense
    tables on one device). ``partitioned`` is a distributed build's
    construction-time hub partition, one ``[n, L]`` table a node (QFDL
    serves straight from it; otherwise its layout comes from the store
    or is synthesized from ``rank``)."""

    def __init__(self, store: Optional[LabelStore] = None, *,
                 l_out: Optional[LabelTable] = None,
                 l_in: Optional[LabelTable] = None,
                 plan: BuildPlan, report: BuildReport, rank: np.ndarray,
                 partitioned: Optional[List[LabelTable]] = None):
        if (store is None) == (l_out is None):
            raise ValueError("exactly one of `store` or the "
                             "`l_out`/`l_in` pair must be given")
        if (l_out is None) != (l_in is None):
            raise ValueError("directed indices need both l_out and l_in")
        if l_out is not None:
            # the card's two-table query reads each row only below its
            # count
            lbl.check_padding(l_out)
            lbl.check_padding(l_in)
        self.store = store
        self.l_out = l_out
        self.l_in = l_in
        self.plan = plan
        self.report = report
        self.rank = np.asarray(rank)
        self.partitioned = partitioned
        # live QueryServices handed out by serve(), kept weakly with
        # the knobs needed to rebuild their answer fns after apply()
        self._services: List[Tuple[weakref.ref, dict]] = []

    # ---------------------------------------------------- properties

    @property
    def directed(self) -> bool:
        return self.store is None

    @property
    def table(self) -> Optional[LabelTable]:
        """The dense label table behind the store (merged from its
        shards, decoded for a compressed store: O(total label slots)
        memory, for analysis, not serving); None for a directed index."""
        return None if self.directed else self.store.to_table()

    @property
    def n(self) -> int:
        return self.l_out.n if self.directed else self.store.n

    @property
    def total_labels(self) -> int:
        if self.directed:
            return lbl.total_labels(self.l_out) + lbl.total_labels(self.l_in)
        return self.store.total_labels

    @property
    def als(self) -> float:
        """Average label size (per direction for a directed graph)."""
        return self.total_labels / max(1, self.n * (2 if self.directed
                                                    else 1))

    # --------------------------------------------------------- query

    def query(self, u, v) -> np.ndarray:
        """Batched PPSD distances (f32 [Q]; +inf when disconnected)."""
        return self.query_with_hub(u, v)[0]

    def query_with_hub(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        """Distances plus the witnessing hub id (-1 when disjoint)."""
        if self.directed:
            d, h = self._directed_query(u, v, with_hub=True)
            return d.cpu().numpy(), h.cpu().numpy()
        return self.store.query(u, v)

    def _directed_query(self, u, v, with_hub: bool = False):
        from repro_torch.core.directed import query_directed
        dev = self.l_out.hubs.device
        return query_directed(self.l_out, self.l_in, as_index(u, dev),
                              as_index(v, dev), with_hub=with_hub)

    # --------------------------------------------------------- serve

    def serve(self, mode: str = "qlsn", *, mesh=None,
              batch_size: int = 1024,
              drop_first: bool = True, deadline_ms: float = 2.0,
              cache: int = 0, max_queue: Optional[int] = None,
              routed: Optional[bool] = None,
              timeout_ms: Optional[float] = None,
              breaker_threshold: int = 5,
              breaker_reset_s: float = 30.0) -> QueryService:
        """The serving tier (:class:`repro_torch.serve.QueryService`)
        over this index's labels in any §6.3 storage mode (``"qlsn"``,
        ``"qfdl"``, ``"qdol"``); see the service for the knobs. ``mesh``
        (a `NodeMesh`) hosts the distributed modes (default: one node
        per device of the store's type). ``routed`` overrides per-shard
        routing of a sharded, spill or compressed store (``None``:
        routed when it has several shards). A spill store serves QLSN
        only. A directed index serves QLSN from its ``L_out``/``L_in`` pair,
        with the answer cache built ``symmetric=False``: d(u->v) and
        d(v->u) never share an entry.

        The returned service stays registered (weakly) with this index:
        :meth:`apply` re-installs every live service's answer fn and
        bumps its cache epoch, so a mutated index never serves a stale
        answer."""
        svc = QueryService(self._answer_fn(mode, mesh=mesh, routed=routed),
                           batch_size=batch_size, drop_first=drop_first,
                           deadline_s=deadline_ms * 1e-3,
                           cache_size=cache, max_queue=max_queue,
                           cache_symmetric=not self.directed,
                           timeout_s=(None if timeout_ms is None
                                      else timeout_ms * 1e-3),
                           breaker_threshold=breaker_threshold,
                           breaker_reset_s=breaker_reset_s)
        self._services.append((weakref.ref(svc),
                               {"mode": mode, "mesh": mesh,
                                "routed": routed}))
        return svc

    def _answer_fn(self, mode: str, mesh=None,
                   routed: Optional[bool] = None):
        """The serving answer callable over the current labels (what
        serve() installs and apply() re-installs)."""
        if self.directed:
            if mode != "qlsn":
                raise NotImplementedError(
                    "directed serving currently supports mode='qlsn'")
            return lambda u, v: self._directed_query(u, v)
        return backends.make_answer_fn(self.store, mode, mesh=mesh,
                                       partitioned=self.partitioned,
                                       rank=self.rank, routed=routed)

    # --------------------------------------------------------- mutate

    def apply(self, mutations, *, graph, ckpt=None, resume: bool = False,
              verbose: bool = False, journal=None):
        """Apply a :class:`repro_torch.dynamic.MutationBatch` to this
        index in place, re-planting only the affected trees, and
        invalidate every live service handed out by :meth:`serve`.

        ``graph`` is the **pre-mutation** graph the index was built on
        (the artifact stores labels, not edges). The repaired labels
        are bit-identical to a from-scratch PLaNT build on
        ``mutations.apply(graph)``; returns the
        :class:`repro_torch.dynamic.RepairReport`. ``ckpt``/``resume``
        checkpoint the repair wave like a build (under
        ``kind="repair"``). ``journal`` (a
        :class:`repro_torch.dynamic.RepairJournal`) makes the repair
        crash-atomic end to end: the intent and the pre-mutation store
        fingerprint are durable before the first label moves, the
        post-repair fingerprint before any save."""
        from repro_torch.dynamic.repair import repair_index
        if journal is not None:
            journal.begin(mutations, self)
        report = repair_index(self, mutations, graph, ckpt=ckpt,
                              resume=resume, verbose=verbose)
        if journal is not None:
            journal.record_post(self)
        self._invalidate_services()
        return report

    def _invalidate_services(self) -> None:
        """Rebuild each live service's answer fn against the mutated
        store and bump its cache epoch; dead services are pruned."""
        alive = []
        for ref, knobs in self._services:
            svc = ref()
            if svc is None:
                continue
            svc.invalidate(self._answer_fn(**knobs))
            alive.append((ref, knobs))
        self._services = alive

    # ------------------------------------------------------ validate

    def validate_against(self, oracle) -> bool:
        """Check this index against ground truth; raises AssertionError
        on a mismatch. ``oracle`` is either a ``Graph`` (every pair's
        distance against Dijkstra: the cover property) or PLL label
        sets (exact CHL label-set equality; an ``(l_out, l_in)`` pair
        for a directed index)."""
        from repro_torch.core import validate as val
        if hasattr(oracle, "indptr"):            # a Graph: cover check
            from repro_torch.sssp.oracle import all_pairs
            D = all_pairs(oracle)
            n = oracle.n
            uu, vv = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
            uu, vv = uu.reshape(-1), vv.reshape(-1)
            got = np.empty(n * n, np.float32)
            step = 8192                  # bound the plain [Q, L, L] cube
            for s in range(0, n * n, step):
                got[s:s + step] = self.query(uu[s:s + step], vv[s:s + step])
            got = got.reshape(n, n)
            want = D.astype(np.float32)
            ok = np.isfinite(want)
            if not np.array_equal(got[ok], want[ok]):
                raise AssertionError("distances differ")
            if np.isfinite(got[~ok]).any():
                raise AssertionError(
                    "reports finite distance for disconnected pair")
            return True
        if self.directed:
            ref_out, ref_in = oracle
            val.check_equal(lbl.to_numpy_sets(self.l_out), ref_out)
            val.check_equal(lbl.to_numpy_sets(self.l_in), ref_in)
        else:
            val.check_equal(lbl.to_numpy_sets(self.table), oracle)
        return True

    # -------------------------------------------------------- memory

    def memory_report(self, q: Optional[int] = None) -> dict:
        """Per-mode cluster label storage (Table 4) for ``q`` nodes
        (default: the build's) plus the store's resident
        ``label_bytes``, bytes per label, the ratio to dense f32 (8 B a
        label) and, for a multi-shard store, the per-shard split (a
        compressed store adds its codec, exactness, dtypes, scales and
        max ulp error); a directed index reports the bytes of each
        direction."""
        from repro_torch.core.query import (label_memory_bytes,
                                            mode_memory_totals)
        q = q or self.report.q
        if self.directed:
            return {"l_out_bytes": label_memory_bytes(self.l_out),
                    "l_in_bytes": label_memory_bytes(self.l_in), "q": q}
        base = self.store.label_bytes()
        total = self.store.total_labels
        out = mode_memory_totals(self.n, base, q)
        out["store"] = self.store.kind
        out["shards"] = self.store.num_shards
        out["label_bytes"] = base
        out["dense_f32_bytes"] = total * 8
        out["bytes_per_label"] = base / max(1, total)
        out["compression_ratio"] = (total * 8) / max(1, base)
        if hasattr(self.store, "shard_label_bytes"):
            out["shard_bytes"] = self.store.shard_label_bytes()
        if isinstance(self.store, CompressedStore):
            out["codec"] = self.store.codec
            out["quant_exact"] = self.store.exact
            out["dtypes"] = self.store.dtypes()
            out["scale"] = self.store.scales
            out["max_ulp_err"] = self.store.max_ulp_err
        return out

    # ---------------------------------------------------------- disk

    def save(self, directory: str) -> str:
        """Atomically write the on-disk artifact (format version 3, one
        shard resident at a time, encoded for a compressed store);
        returns its path."""
        parent = os.path.dirname(os.path.abspath(directory)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(parent,
                           f".tmp_index_{os.path.basename(directory)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.save(os.path.join(tmp, "rank.npy"), self.rank)

        def write_shard(k: int, arrays: dict) -> str:
            path = os.path.join(tmp, shard_filename(k))
            with_retries(lambda: np.savez(path, **arrays),
                         describe=f"index shard {k}")
            fault_site("artifact.save.shard", path=path)
            return file_sha256(path)

        if self.directed:
            arrays = {f"{pfx}_{key}": x.cpu().numpy()
                      for pfx, t in (("out", self.l_out), ("in", self.l_in))
                      for key, x in zip(("hubs", "dist", "count"), t)}
            shard_sha = [write_shard(0, arrays)]
            store_info = {"kind": "dense", "shards": 1,
                          "shard_labels": [self.total_labels]}
        else:
            shard_labels, shard_sha = [], []
            for k, arrs in self.store.shard_arrays():
                shard_sha.append(write_shard(k, arrs))
                shard_labels.append(int(np.sum(arrs["count"])))
            compressed = isinstance(self.store, CompressedStore)
            # encoded shards persist as they are; the codec fields let
            # the loader decode them (or keep serving them encoded)
            kind = ("compressed" if compressed else
                    "sharded" if self.store.num_shards > 1 else "dense")
            store_info = {"kind": kind, "shards": self.store.num_shards,
                          "shard_labels": shard_labels}
            if compressed:
                store_info.update(self.store.manifest_info())
        # per-file integrity, verified on load
        store_info["shard_sha256"] = shard_sha
        manifest = {
            "format": FORMAT,
            "version": VERSION,
            "plan": self.plan.to_dict(),
            "report": self.report.to_dict(),
            "rank_hash": rank_hash(self.rank),
            "directed": self.directed,
            "n": self.n,
            "total_labels": self.total_labels,
            "als": self.als,
            "store": store_info,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        fault_site("artifact.save.commit",
                   path=os.path.join(tmp, "manifest.json"))
        old = tmp + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(directory):
            # move the live artifact aside before the swap: a crash
            # leaves either the old or the new one loadable
            os.replace(directory, old)
        os.replace(tmp, directory)
        shutil.rmtree(old, ignore_errors=True)
        return directory

    @classmethod
    def load(cls, directory: str, rank: Optional[np.ndarray] = None, *,
             store: Optional[str] = None, shards: Optional[int] = None,
             codec: Optional[str] = None, quant_exact: bool = False,
             device: DeviceLike = None, verify: bool = True) -> "CHLIndex":
        """Load a saved index (any version) onto ``device`` (default: the
        card; raises without CUDA). When ``rank`` is given it must hash
        to the manifest's ``rank_hash``.

        ``store`` overrides the saved residency: ``"dense"`` merges the
        shards, ``"sharded"`` (re-)partitions by hub rank (``shards``
        picks K; a sharded artifact keeps its K unless ``shards``
        differs), ``"spill"`` memory-maps the shard files (each query's
        rows are intersected on ``device``), ``"compressed"`` encodes
        the labels (``codec``, default bf16 or the artifact's own;
        ``quant_exact`` demands the validated bit-exact encoding and
        raises a typed ``QuantizationError`` when the labels cannot
        satisfy it). A compressed artifact cannot be memory-mapped; a
        directed index loads dense only. ``verify`` (default on)
        re-hashes every shard file against the manifest's sha256 and
        raises :class:`CorruptArtifactError` on a mismatch; the
        per-shard label-count check runs either way."""
        if store is not None and store not in LOAD_STORE_KINDS:
            raise ValueError(f"store {store!r} not one of "
                             f"{LOAD_STORE_KINDS}")
        dev = resolve_device(device)
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{directory}: not a CHL index artifact "
                f"(format={manifest.get('format')!r})")
        version = manifest.get("version", 0)
        if version > VERSION:
            raise ValueError(
                f"{directory}: index version {version} is newer than "
                f"supported ({VERSION})")
        plan = BuildPlan.from_dict(manifest["plan"])
        report = BuildReport.from_dict(manifest["report"])
        if verify:
            cls._verify_checksums(directory, manifest)
        loader = cls._load_v1 if version < 2 else cls._load_v2
        stored_rank, built = loader(directory, manifest,
                                    spill=store == "spill", device=dev)
        if rank_hash(stored_rank) != manifest["rank_hash"]:
            raise CorruptArtifactError(
                f"{directory}: stored rank does not match manifest "
                "rank_hash (corrupt artifact)")
        if rank is not None and rank_hash(rank) != manifest["rank_hash"]:
            raise ValueError(
                f"{directory}: rank-hash mismatch — this index was "
                "built under a different vertex hierarchy")
        if manifest["directed"]:
            if store not in (None, "dense"):
                raise NotImplementedError(
                    "directed indices support only dense residency")
            l_out, l_in = built
            return cls(l_out=l_out, l_in=l_in, plan=plan, report=report,
                       rank=stored_rank)
        built = cls._rehome(built, store, stored_rank, shards,
                            codec=codec, quant_exact=quant_exact)
        return cls(built, plan=plan, report=report, rank=stored_rank)

    # ------------------------------------------------- load internals

    @staticmethod
    def _verify_checksums(directory: str, manifest: dict) -> None:
        """Refuse shard files whose bytes no longer hash to what the
        manifest recorded (pre-checksum artifacts carry none)."""
        recorded = (manifest.get("store") or {}).get("shard_sha256")
        if not recorded:
            return
        for k, want in enumerate(recorded):
            path = os.path.join(directory, shard_filename(k))
            try:
                got = file_sha256(path)
            except FileNotFoundError as e:
                raise CorruptArtifactError(
                    f"missing shard file {path} — artifact is "
                    "incomplete (copy interrupted?)") from e
            except OSError as e:
                raise CorruptArtifactError(
                    f"{directory}: {shard_filename(k)} unreadable "
                    f"while verifying checksum ({e})") from e
            if got != want:
                raise CorruptArtifactError(
                    f"{directory}: {shard_filename(k)} sha256 mismatch "
                    f"(manifest {want[:12]}…, on disk {got[:12]}…) — "
                    "corrupt artifact (torn write or bit rot)")

    @staticmethod
    def _load_v1(directory: str, manifest: dict, *, spill: bool, device):
        """Version-1 monolithic ``arrays.npz`` -> dense residency, as
        the reference loads it (``spill`` maps the members instead: one
        big shard)."""
        path = os.path.join(directory, "arrays.npz")
        if spill and not manifest["directed"]:
            arrs = open_npz_arrays(path, path)
            return np.asarray(arrs["rank"]), SpillStore(
                [{k: arrs[k] for k in ("hubs", "dist", "count")}],
                device=device)
        with np.load(path) as z:
            arrs = {name: z[name] for name in z.files}

        def tbl(pfx: str) -> LabelTable:
            return interop.label_table(arrs[f"{pfx}hubs"], arrs[f"{pfx}dist"],
                                       arrs[f"{pfx}count"], device)

        if manifest["directed"]:
            return arrs["rank"], (tbl("out_"), tbl("in_"))
        return arrs["rank"], DenseStore(tbl(""))

    @staticmethod
    def _load_v2(directory: str, manifest: dict, *, spill: bool, device):
        """Version-2/3 per-shard files (each label count checked against
        the manifest) -> the saved residency, or memory maps."""
        stored_rank = np.load(os.path.join(directory, "rank.npy"))
        info = manifest.get("store") or {}
        K = int(info.get("shards", 1))
        expected = info.get("shard_labels")
        directed = bool(manifest["directed"])
        shards = []
        for k in range(K):
            arrs = open_shard(directory, k)
            if expected is not None:
                got = (int(np.sum(arrs["out_count"])
                           + np.sum(arrs["in_count"]))
                       if directed else int(np.sum(arrs["count"])))
                if got != int(expected[k]):
                    raise CorruptArtifactError(
                        f"{directory}: {shard_filename(k)} holds {got} "
                        f"labels but the manifest recorded "
                        f"{int(expected[k])} (corrupt or mixed-version "
                        "artifact)")
            shards.append(arrs)
        if directed:
            (s,) = shards

            def tbl(pfx: str) -> LabelTable:
                return interop.label_table(s[f"{pfx}_hubs"], s[f"{pfx}_dist"],
                                           s[f"{pfx}_count"], device)

            return stored_rank, (tbl("out"), tbl("in"))
        if info.get("kind") == "compressed":
            if spill:
                raise ValueError(
                    "a compressed artifact cannot be memory-mapped "
                    "(queries must dequantize); load with "
                    "store='compressed' (encoded residency) or "
                    "'dense'/'sharded' (decoded)")
            return stored_rank, CompressedStore.from_encoded_shards(
                shards, info, stored_rank, device=device)
        if spill:
            return stored_rank, SpillStore(shards, device=device)
        if info.get("kind") == "sharded" or K > 1:
            return stored_rank, ShardedStore.from_shard_arrays(
                shards, device=device)
        return stored_rank, DenseStore.from_shard_arrays(shards,
                                                         device=device)

    @staticmethod
    def _rehome(store: LabelStore, kind: Optional[str], rank: np.ndarray,
                shards: Optional[int], *, codec: Optional[str] = None,
                quant_exact: bool = False) -> LabelStore:
        """Convert a loaded store to the requested residency (on its
        device)."""
        if kind is None or kind == "spill":
            return store          # spill was honoured at open time
        if kind == "dense":
            return (store if isinstance(store, DenseStore)
                    else DenseStore(store.to_table()))
        if kind == "compressed":
            if isinstance(store, CompressedStore) \
                    and codec in (None, store.codec) \
                    and shards in (None, store.num_shards) \
                    and (not quant_exact or store.exact):
                return store      # already encoded as requested
            return CompressedStore.from_store(
                store, rank, codec=codec or "bf16", exact=quant_exact,
                shards=shards)
        # "sharded": repartition unless the shard count already matches
        if isinstance(store, ShardedStore) and shards in (
                None, store.num_shards):
            return store
        K = shards or max(2, store.num_shards)
        return ShardedStore.from_table(store.to_table(), rank, K)

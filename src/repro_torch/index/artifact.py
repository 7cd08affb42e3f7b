"""`CHLIndex` — the queryable, servable, persistable CHL artifact.

One object owns the outcome of a build: a label store, the plan that
produced it, the build report and the vertex hierarchy::

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
                           "store": {"kind", "shards", "shard_labels",
                                     "shard_sha256"}}
    <dir>/rank.npy        the vertex hierarchy
    <dir>/shard_<k>.npz   hubs/dist/count of label shard k

Loads verify every shard file against its recorded sha256, the
per-shard label counts and the rank hash. Writes go through a tmp dir
and ``os.replace``: an overwrite never deletes the live artifact before
the replacement is staged; shard writes retry transient I/O and pass
the ``artifact.save.shard`` / ``artifact.save.commit`` fault sites, shard
reads ``artifact.load.shard``. This slice saves and loads dense
artifacts; sharded, spill and compressed residency and the v1/v2
formats are still to port.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import weakref
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import interop
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.inject import fault_site, with_retries
from repro_torch.index.plan import BuildPlan
from repro_torch.index.report import BuildReport
from repro_torch.index.store import (CorruptArtifactError, DenseStore,
                                     LabelStore, shard_filename)
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
    """A built Canonical Hub Labeling, packaged for serving."""

    def __init__(self, store: LabelStore, *, plan: BuildPlan,
                 report: BuildReport, rank: np.ndarray):
        self.store = store
        self.plan = plan
        self.report = report
        self.rank = np.asarray(rank)
        # live QueryServices handed out by serve(), kept weakly with
        # the mode needed to rebuild their answer fns after apply()
        self._services: List[Tuple[weakref.ref, str]] = []

    # ---------------------------------------------------- properties

    @property
    def table(self):
        """The dense label table behind the store."""
        return self.store.to_table()

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def total_labels(self) -> int:
        return self.store.total_labels

    @property
    def als(self) -> float:
        """Average label size."""
        return self.total_labels / max(1, self.n)

    # --------------------------------------------------------- query

    def query(self, u, v) -> np.ndarray:
        """Batched PPSD distances (f32 [Q]; +inf when disconnected)."""
        return self.query_with_hub(u, v)[0]

    def query_with_hub(self, u, v) -> Tuple[np.ndarray, np.ndarray]:
        """Distances plus the witnessing hub id (-1 when disjoint)."""
        return self.store.query(u, v)

    # --------------------------------------------------------- serve

    def serve(self, mode: str = "qlsn", *, batch_size: int = 1024,
              drop_first: bool = True, deadline_ms: float = 2.0,
              cache: int = 0, max_queue: Optional[int] = None,
              timeout_ms: Optional[float] = None,
              breaker_threshold: int = 5,
              breaker_reset_s: float = 30.0) -> QueryService:
        """The serving tier (:class:`repro_torch.serve.QueryService`)
        over this index's labels; see the service for the knobs.

        The returned service stays registered (weakly) with this index:
        :meth:`apply` re-installs every live service's answer fn and
        bumps its cache epoch, so a mutated index never serves a stale
        answer."""
        svc = QueryService(self._answer_fn(mode), batch_size=batch_size,
                           drop_first=drop_first,
                           deadline_s=deadline_ms * 1e-3,
                           cache_size=cache, max_queue=max_queue,
                           cache_symmetric=True,
                           timeout_s=(None if timeout_ms is None
                                      else timeout_ms * 1e-3),
                           breaker_threshold=breaker_threshold,
                           breaker_reset_s=breaker_reset_s)
        self._services.append((weakref.ref(svc), mode))
        return svc

    def _answer_fn(self, mode: str):
        """The serving answer callable over the current labels (what
        serve() installs and apply() re-installs)."""
        return backends.make_answer_fn(self.store, mode)

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
        for ref, mode in self._services:
            svc = ref()
            if svc is None:
                continue
            svc.invalidate(self._answer_fn(mode))
            alive.append((ref, mode))
        self._services = alive

    # ------------------------------------------------------ validate

    def validate_against(self, oracle) -> bool:
        """Check this index against ground truth; raises AssertionError
        on a mismatch. ``oracle`` is either a ``Graph`` (every pair's
        distance against Dijkstra: the cover property) or PLL label
        sets (exact CHL label-set equality)."""
        from repro_torch.core import labels as lbl
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
        val.check_equal(lbl.to_numpy_sets(self.table), oracle)
        return True

    # -------------------------------------------------------- memory

    def memory_report(self, q: Optional[int] = None) -> dict:
        """Per-mode cluster label storage (Table 4) for ``q`` nodes
        (default: the build's) plus the store's resident
        ``label_bytes``, bytes per label and the ratio to dense f32
        (8 B a label)."""
        from repro_torch.core.query import mode_memory_totals
        q = q or self.report.q
        base = self.store.label_bytes()
        total = self.store.total_labels
        out = mode_memory_totals(self.n, base, q)
        out["store"] = self.store.kind
        out["shards"] = self.store.num_shards
        out["label_bytes"] = base
        out["dense_f32_bytes"] = total * 8
        out["bytes_per_label"] = base / max(1, total)
        out["compression_ratio"] = (total * 8) / max(1, base)
        return out

    # ---------------------------------------------------------- disk

    def save(self, directory: str) -> str:
        """Atomically write the on-disk artifact; returns its path."""
        parent = os.path.dirname(os.path.abspath(directory)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(parent,
                           f".tmp_index_{os.path.basename(directory)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.save(os.path.join(tmp, "rank.npy"), self.rank)
        shard_labels, shard_sha = [], []
        for k, arrs in self.store.shard_arrays():
            path = os.path.join(tmp, shard_filename(k))
            with_retries(lambda: np.savez(path, **arrs),
                         describe=f"index shard {k}")
            fault_site("artifact.save.shard", path=path)
            shard_sha.append(file_sha256(path))
            shard_labels.append(int(np.sum(arrs["count"])))
        store_info = {"kind": "dense", "shards": self.store.num_shards,
                      "shard_labels": shard_labels,
                      "shard_sha256": shard_sha}
        manifest = {
            "format": FORMAT,
            "version": VERSION,
            "plan": self.plan.to_dict(),
            "report": self.report.to_dict(),
            "rank_hash": rank_hash(self.rank),
            "directed": False,
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
             device: DeviceLike = None) -> "CHLIndex":
        """Load a saved dense index onto ``device`` (default: the card;
        raises without CUDA). When ``rank`` is given it must hash to
        the manifest's ``rank_hash``. Every shard file is re-hashed
        against the manifest's sha256; a mismatch raises
        :class:`CorruptArtifactError`."""
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
        info = manifest.get("store") or {}
        if version < VERSION or manifest.get("directed") \
                or info.get("kind") != "dense" \
                or int(info.get("shards", 1)) != 1:
            raise NotImplementedError(
                f"{directory}: only undirected dense version-{VERSION} "
                "artifacts load in this port (v1/v2 artifacts: ROADMAP "
                "Queue 1, item 6; directed: item 8; sharded and "
                "compressed: item 9)")
        plan = BuildPlan.from_dict(manifest["plan"])
        report = BuildReport.from_dict(manifest["report"])
        cls._verify_checksums(directory, manifest)
        stored_rank = np.load(os.path.join(directory, "rank.npy"))
        if rank_hash(stored_rank) != manifest["rank_hash"]:
            raise CorruptArtifactError(
                f"{directory}: stored rank does not match manifest "
                "rank_hash (corrupt artifact)")
        if rank is not None and rank_hash(rank) != manifest["rank_hash"]:
            raise ValueError(
                f"{directory}: rank-hash mismatch — this index was "
                "built under a different vertex hierarchy")
        arrs = cls._open_shard(directory, 0)
        expected = info.get("shard_labels")
        got = int(np.sum(arrs["count"]))
        if expected is not None and got != int(expected[0]):
            raise CorruptArtifactError(
                f"{directory}: {shard_filename(0)} holds {got} labels but "
                f"the manifest recorded {int(expected[0])}")
        table = interop.label_table(arrs["hubs"], arrs["dist"],
                                    arrs["count"], dev)
        return cls(DenseStore(table), plan=plan, report=report,
                   rank=stored_rank)

    @staticmethod
    def _open_shard(directory: str, k: int) -> dict:
        path = os.path.join(directory, shard_filename(k))
        fault_site("artifact.load.shard", path=path)
        try:
            with np.load(path) as z:
                return {name: z[name] for name in ("hubs", "dist", "count")}
        except (OSError, KeyError, ValueError, EOFError,
                zipfile.BadZipFile) as e:
            raise CorruptArtifactError(
                f"{directory}: {shard_filename(k)} unreadable ({e})") from e

    @staticmethod
    def _verify_checksums(directory: str, manifest: dict) -> None:
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
                    "incomplete") from e
            if got != want:
                raise CorruptArtifactError(
                    f"{directory}: {shard_filename(k)} sha256 mismatch "
                    f"(manifest {want[:12]}…, on disk {got[:12]}…) — "
                    "corrupt artifact")

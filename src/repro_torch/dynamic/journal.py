"""Crash-atomic repair: a durable journal around ``CHLIndex.apply``.

The repair wave mutates the index *in memory* and the artifact swap in
``CHLIndex.save`` is atomic, so the on-disk artifact is always either
fully pre-mutation or fully post-mutation. What a bare kill still
loses is *which* — and whether a repair was in flight at all. The
journal closes that gap:

    journal = RepairJournal.for_artifact(index_dir)
    idx.apply(batch, graph=g, journal=journal)   # begin + record_post
    idx.save(index_dir)                          # atomic swap
    journal.finish()                             # intent discharged

``begin`` makes the intent durable — the full mutation batch, its
fingerprint, and the sha256 fingerprint of the pre-mutation store —
*before* the first label moves. ``record_post`` adds the post-repair
fingerprint before the swap can happen. On restart,
:meth:`RepairJournal.recover` fingerprints the reloaded store and
answers the only question that matters: ``"post"`` (the swap landed —
drop the journal, done) or ``"pre"`` (it didn't — re-run ``apply``
with the journaled batch, which is deterministic and lands
bit-identically). A fingerprint matching neither means the artifact
was tampered with out-of-band and raises
:class:`~repro_torch.index.store.CorruptArtifactError`.

The journal lives *next to* the artifact directory (``<dir>.repair_
journal.json``), never inside it — the directory itself is what the
save path atomically replaces.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from repro_torch.dynamic.mutations import MutationBatch
from repro_torch.index.store.base import CorruptArtifactError

#: journal schema version
JOURNAL_VERSION = 1


def store_fingerprint(store) -> str:
    """Content hash of a label store — every shard's hubs/dist/count
    bytes plus shapes/dtypes, shard order fixed. Two stores fingerprint
    equal iff their label arrays are bit-identical (the same relation
    the dynamic subsystem's rebuild-parity gate checks)."""
    h = hashlib.sha256()
    for k, arrs in store.shard_arrays():
        h.update(str(k).encode())
        for key in sorted(arrs):
            a = np.asarray(arrs[key])
            h.update(key.encode())
            h.update(str(a.shape).encode())
            h.update(a.dtype.str.encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class RepairJournal:
    """Durable intent record for one repair of one artifact."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def for_artifact(cls, directory: str) -> "RepairJournal":
        """The canonical journal path for an artifact directory — a
        sibling file, because the directory itself gets swapped."""
        return cls(os.path.normpath(directory) + ".repair_journal.json")

    # ------------------------------------------------------- protocol

    def _write(self, record: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def begin(self, batch: MutationBatch, idx) -> None:
        """Durably record intent before any label moves. Refuses to
        start when an unfinished journal is already present — recover
        that one first."""
        pending = self.pending()
        if pending is not None:
            raise RuntimeError(
                f"unfinished repair journal at {self.path} (state="
                f"{pending['state']!r}); run recover() before starting "
                "a new repair")
        self._write({
            "version": JOURNAL_VERSION,
            "state": "begun",
            "batch": batch.to_dict(),
            "batch_fingerprint": batch.fingerprint(),
            "pre": store_fingerprint(idx.store),
        })

    def record_post(self, idx) -> None:
        """Record the post-repair store fingerprint (the repair ran to
        completion in memory; the artifact swap may still be ahead)."""
        record = self.pending()
        if record is None:
            raise RuntimeError(f"record_post without begin ({self.path})")
        record["state"] = "repaired"
        record["post"] = store_fingerprint(idx.store)
        self._write(record)

    def finish(self) -> None:
        """Discharge the intent — the post-mutation artifact is on
        disk. Idempotent."""
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass

    # ------------------------------------------------------- recovery

    def pending(self) -> Optional[dict]:
        """The unfinished journal record, or None. A torn journal file
        (the process died inside ``_write``'s tmp stage) reads as no
        journal — ``_write`` itself is atomic, so a parse failure can
        only be out-of-band damage and is surfaced."""
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            try:
                return json.load(f)
            except json.JSONDecodeError as e:
                raise CorruptArtifactError(
                    f"repair journal {self.path} is unparseable "
                    f"({e}); it was written atomically, so this is "
                    "out-of-band damage") from e

    def batch(self) -> MutationBatch:
        """The journaled mutation batch (to re-run a ``"pre"``
        recovery)."""
        record = self.pending()
        if record is None:
            raise RuntimeError(f"no repair journal at {self.path}")
        batch = MutationBatch.from_dict(record["batch"])
        if batch.fingerprint() != record["batch_fingerprint"]:
            raise CorruptArtifactError(
                f"repair journal {self.path}: batch fingerprint "
                "mismatch — journal damaged out-of-band")
        return batch

    def recover(self, idx) -> str:
        """Classify the reloaded artifact against the journaled
        fingerprints.

        Returns ``"post"`` (the swap landed; the journal is finished
        for you) or ``"pre"`` (the kill beat the swap; re-run
        ``idx.apply(journal.batch(), ...)`` — after ``finish()`` — to
        land the repair). Any other fingerprint raises
        :class:`CorruptArtifactError`: an atomic swap cannot produce a
        third state.
        """
        record = self.pending()
        if record is None:
            raise RuntimeError(f"no repair journal at {self.path}")
        fp = store_fingerprint(idx.store)
        if record.get("post") is not None and fp == record["post"]:
            self.finish()
            return "post"
        if fp == record["pre"]:
            return "pre"
        raise CorruptArtifactError(
            f"store fingerprint {fp[:12]}… matches neither the "
            f"journaled pre ({record['pre'][:12]}…) nor post "
            f"({str(record.get('post'))[:12]}…) state — the artifact "
            "changed out-of-band while a repair was journaled")

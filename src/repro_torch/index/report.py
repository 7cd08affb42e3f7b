"""`BuildReport` — the typed stats contract of a build (a copy of the
reference package's, so that ``to_dict()`` and manifests match).

The engine's typed per-superstep records feed ``BuildReport.supersteps``
directly; :func:`normalize_stats` maps the legacy ``*_chl`` stats dicts
(a distributed trace, PLaNT's per-batch lists, GLL's counters) onto the
same fields."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.engine.records import SuperstepRecord

#: one committed superstep (or root batch) of construction
SuperstepStat = SuperstepRecord


@dataclasses.dataclass(frozen=True)
class OverflowEvent:
    """One label-table overflow + regrow step inside ``build``."""
    attempt: int
    cap: int                        # the cap that overflowed
    regrown_to: Optional[int]       # None: gave up (retries exhausted)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class BuildReport:
    algo: str
    wall_s: float
    total_labels: int
    als: float                       # average label size
    cap: int                         # final (possibly regrown) cap
    supersteps: List[SuperstepStat] = dataclasses.field(
        default_factory=list)
    overflow_events: List[OverflowEvent] = dataclasses.field(
        default_factory=list)
    comm_label_slots: int = 0        # broadcast volume (distributed)
    psi_threshold: Optional[float] = None
    q: int = 1                       # mesh size
    cleaned: int = 0                 # DQ_Clean removals (GLL/LCC)
    constructed: int = 0             # optimistic emissions (GLL/LCC)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def cap_retries(self) -> int:
        return len(self.overflow_events)

    @property
    def max_psi(self) -> float:
        vals = [s.psi for s in self.supersteps if s.psi is not None]
        return max(vals) if vals else 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BuildReport":
        d = dict(d)
        d["supersteps"] = [SuperstepStat(**s)
                           for s in d.get("supersteps", [])]
        d["overflow_events"] = [OverflowEvent(**e)
                                for e in d.get("overflow_events", [])]
        return cls(**d)

    def summary(self) -> str:
        parts = [f"algo={self.algo}", f"labels={self.total_labels}",
                 f"ALS={self.als:.1f}", f"cap={self.cap}",
                 f"supersteps={len(self.supersteps)}",
                 f"wall={self.wall_s:.1f}s"]
        if self.cap_retries:
            parts.append(f"cap_retries={self.cap_retries}")
        if self.comm_label_slots:
            parts.append(f"comm_slots={self.comm_label_slots:,}")
        return " ".join(parts)


def normalize_stats(algo: str, stats: Optional[dict]) -> dict:
    """Map a ``*_chl`` stats dict onto ``BuildReport`` keyword arguments
    (all but algo/wall/labels/als/cap, which a caller computes)."""
    out: dict = {"supersteps": [], "comm_label_slots": 0,
                 "psi_threshold": None, "q": 1,
                 "cleaned": 0, "constructed": 0}
    if not stats:
        return out
    if "mode" in stats:              # distributed driver trace
        sweeps = stats.get("sweeps", [None] * len(stats["mode"]))
        out["supersteps"] = [
            SuperstepStat(mode=m, labels=l, explored=e, sweeps=s, psi=p)
            for m, l, e, s, p in zip(stats["mode"], stats["labels"],
                                     stats["explored"], sweeps,
                                     stats["psi"])]
        out["comm_label_slots"] = int(stats.get("comm_label_slots", 0))
        out["psi_threshold"] = stats.get("psi_threshold")
        out["q"] = int(stats.get("q", 1))
    elif "psi" in stats:             # plant_chl per-batch lists
        sweeps = stats.get("sweeps", [None] * len(stats["psi"]))
        out["supersteps"] = [
            SuperstepStat(mode="plant", labels=l, explored=e,
                          sweeps=s, psi=p)
            for l, e, s, p in zip(stats["labels"], stats["explored"],
                                  sweeps, stats["psi"])]
    elif "superstep_sizes" in stats:  # gll_chl counters
        out["supersteps"] = [SuperstepStat(mode=algo, labels=sz)
                             for sz in stats["superstep_sizes"]]
        out["cleaned"] = int(stats.get("cleaned", 0))
        out["constructed"] = int(stats.get("constructed", 0))
    return out

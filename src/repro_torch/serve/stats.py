"""`ServiceStats` — the serving tier's observability surface.

One typed accumulator for :class:`repro_torch.serve.QueryService`.
It keeps the reference package's accounting contract (``queries`` /
``batches`` / ``busy_s`` / ``warmup_s`` / ``lat_samples`` and the
drop-first warmup split) and adds the
service-tier signals: queue depth, admission rejections, batch
occupancy (real queries vs launched kernel slots — the zero-pad
waste), cache hit rate, and per-stage latency samples (queue wait,
kernel answer, submit→done total).

Percentiles over *no* samples report ``nan``, never a fabricated 0.0:
an empty run must be visibly empty, so it can be skipped rather than
recorded as "0 ms p99".

Sample lists are bounded deques (``SAMPLE_CAP`` most recent) — a
long-lived server must not grow host memory without bound just to
keep percentiles.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque

import numpy as np

#: most-recent samples retained per latency stage; percentiles are
#: computed over this window, so a long-lived server stays O(1) memory
SAMPLE_CAP = 65536


def percentile_ms(samples, q: float) -> float:
    """Percentile of a seconds-sample window in milliseconds;
    ``nan`` when there are no samples (never a fabricated 0.0)."""
    if not samples:
        return float("nan")
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q)
                 * 1e3)


def _new_window() -> Deque[float]:
    return deque(maxlen=SAMPLE_CAP)


@dataclasses.dataclass
class ServiceStats:
    # legacy accounting (batch-sync contract)
    queries: int = 0               # answered queries (cache hits incl.)
    batches: int = 0               # kernel launches
    busy_s: float = 0.0            # measured kernel seconds
    warmup_s: float = 0.0          # compile/first-batch time, kept apart
    measured_queries: int = 0      # launched queries behind busy_s

    # admission / queue
    admitted: int = 0
    rejected: int = 0              # bounced at the admission gate
    queue_depth: int = 0           # pending right now
    queue_depth_max: int = 0

    # batching
    real_slots: int = 0            # genuine queries launched
    launched_slots: int = 0        # kernel slots launched (incl. pad)

    # cache
    cache_hits: int = 0
    cache_misses: int = 0
    invalidations: int = 0         # index-mutation epoch bumps served

    # faults: the degradation counters health() reads
    answer_failures: int = 0       # kernel/answer-fn launches that raised
    failed_queries: int = 0        # queries answered with an error
    timeouts: int = 0              # queries expired past timeout_s
    breaker_trips: int = 0         # closed/half-open → open transitions
    breaker_fast_fails: int = 0    # submissions refused while open

    # per-stage latency windows (seconds)
    lat_samples: Deque[float] = dataclasses.field(
        default_factory=_new_window)            # per-batch answer time
    queue_wait_samples: Deque[float] = dataclasses.field(
        default_factory=_new_window)            # per-query submit→launch
    total_lat_samples: Deque[float] = dataclasses.field(
        default_factory=_new_window)            # per-query submit→done

    # ------------------------------------------------------- derived

    @property
    def cache_hit_rate(self) -> float:
        looked = self.cache_hits + self.cache_misses
        return self.cache_hits / looked if looked else float("nan")

    @property
    def batch_occupancy(self) -> float:
        """Real queries per launched kernel slot (1.0 = no pad waste)."""
        return (self.real_slots / self.launched_slots
                if self.launched_slots else float("nan"))

    @property
    def throughput_qps(self) -> float:
        """Kernel-side throughput over the measured queries only — a
        warmup batch contributes neither time nor count, so a
        single-batch caller reports 0 rather than N/epsilon."""
        return self.measured_queries / max(self.busy_s, 1e-9)

    @property
    def capacity_qps(self) -> float:
        """Service capacity including cache absorption: answered
        queries (hits + launched) per measured kernel second."""
        return ((self.measured_queries + self.cache_hits)
                / max(self.busy_s, 1e-9))

    def summary(self) -> dict:
        return {
            # legacy keys first — existing dashboards/tests read these
            "queries": self.queries,
            "batches": self.batches,
            "throughput_qps": self.throughput_qps,
            "p50_ms": percentile_ms(self.lat_samples, 50),
            "p99_ms": percentile_ms(self.lat_samples, 99),
            "warmup_ms": self.warmup_s * 1e3,
            # service tier
            "capacity_qps": self.capacity_qps,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "queue_depth": self.queue_depth,
            "queue_depth_max": self.queue_depth_max,
            "batch_occupancy": self.batch_occupancy,
            "cache_hit_rate": self.cache_hit_rate,
            "invalidations": self.invalidations,
            "queue_p50_ms": percentile_ms(self.queue_wait_samples, 50),
            "queue_p99_ms": percentile_ms(self.queue_wait_samples, 99),
            "total_p50_ms": percentile_ms(self.total_lat_samples, 50),
            "total_p99_ms": percentile_ms(self.total_lat_samples, 99),
            # faults
            "answer_failures": self.answer_failures,
            "failed_queries": self.failed_queries,
            "timeouts": self.timeouts,
            "breaker_trips": self.breaker_trips,
            "breaker_fast_fails": self.breaker_fast_fails,
        }

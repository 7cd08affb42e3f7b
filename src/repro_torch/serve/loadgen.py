"""Open-loop load generation for the serving tier.

An *open-loop* generator fires queries at their scheduled Poisson
arrival times regardless of how the service is keeping up — the
honest way to measure tail latency (a closed loop self-throttles and
hides queueing delay). Between arrivals the driver keeps pumping the
service so deadline-due partial batches go out on time.

``zipf_pairs`` builds the skewed endpoint workload real traffic looks
like (a few hot vertices dominate), which is what the hot-pair answer
cache is for.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.serve.service import QueryService


def zipf_pairs(n: int, num_queries: int, rng: np.random.Generator,
               a: float = 1.3) -> Tuple[np.ndarray, np.ndarray]:
    """Skewed endpoint pairs: both endpoints Zipf(a)-distributed over
    the vertex ids (hot vertices repeat — the cacheable regime)."""
    u = (rng.zipf(a, num_queries) - 1) % n
    v = (rng.zipf(a, num_queries) - 1) % n
    return u.astype(np.int32), v.astype(np.int32)


def poisson_open_loop(svc: QueryService, u: np.ndarray, v: np.ndarray,
                      arrival_qps: float, *,
                      rng: Optional[np.random.Generator] = None,
                      warm_buckets: bool = True) -> dict:
    """Drive ``svc`` with Poisson arrivals at ``arrival_qps`` in real
    time; returns ``svc.stats()`` plus offered-load bookkeeping.

    Queries arrive on schedule and are *dropped* (counted rejected)
    when the admission queue is full — open loop, no caller throttling.
    Latency percentiles come from the service's own per-query
    submit→done samples, so they include queue wait.
    """
    if arrival_qps <= 0:
        raise ValueError("arrival_qps must be > 0")
    rng = rng or np.random.default_rng(0)
    n_q = len(u)
    if len(v) != n_q:
        raise ValueError("u/v length mismatch")
    if warm_buckets:
        svc.warmup(buckets=True)
    arrive = np.cumsum(rng.exponential(1.0 / arrival_qps, n_q))
    t0 = time.perf_counter()
    for i in range(n_q):
        target = t0 + arrive[i]
        while True:
            now = time.perf_counter()
            if now >= target:
                break
            svc.pump()
            slack = target - time.perf_counter()
            if slack > 1e-4:
                time.sleep(min(slack, 1e-3))
        svc.try_submit(int(u[i]), int(v[i]))    # None = rejected (open
        # loop drops it; the service's stats count the rejection)
    svc.drain()
    wall = time.perf_counter() - t0
    out = svc.stats()
    out["offered_qps"] = arrival_qps
    out["offered_queries"] = n_q
    out["wall_s"] = wall
    return out

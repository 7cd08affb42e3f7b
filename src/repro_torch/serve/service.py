"""`QueryService` — the continuous-batching PPSD serving tier.

The paper reduces a PPSD query to one cheap label intersection
(§6.3); this module turns that kernel into a *service*. Layering, top
to bottom:

    admission queue   bounded depth; overload is rejected at the gate
         │            (backpressure) instead of growing host memory
    answer cache      hot-pair LRU in front of the kernel — skewed
         │            traffic absorbs most hits; bit-identical values
    micro-batcher     coalesces arrivals into one `label_query`-sized
         │            launch: flush on batch-full or deadline; the
         │            tail is CARRIED to the next batch, not zero-
         │            padded away per flush (forced partial flushes
         │            pad to a power-of-two bucket, bounding both the
         │            waste and the number of launch shapes)
    answer fn         `repro_torch.serve.backends.make_answer_fn` —
                      the storage-mode wiring (QLSN over a dense
                      or hub-sharded store)

Construction goes through ``CHLIndex.serve(...)``.

Two call styles:

- **per-query** (the open-loop / production shape)::

      tk = svc.try_submit(u, v)        # None = rejected (queue full)
      svc.pump()                       # fire deadline-due batches
      ... tk.done / tk.value

- **batch-sync** (benchmarks)::

      svc.submit(u_array, v_array)     # enqueues; full batches launch
      out = svc.flush()                # drains; answers in order

Latency accounting keeps the legacy drop-first contract: unless
``warmup()`` was called, the first launch is treated as the compile
sample — recorded in ``ServiceStats.warmup_s``, excluded from the
percentiles and busy time.

Degradation: a failing answer fn (a lost device, a poisoned kernel)
must degrade the service, not kill the process or
fabricate distances. Three mechanisms, all observable through
``ServiceStats`` and :meth:`QueryService.health`:

- **per-query timeouts** (``timeout_s``): a query that has waited
  longer than its budget by the time its batch launches is expired —
  ``Ticket.error = "timeout"``, value ``nan`` — instead of burning a
  kernel slot on an answer nobody is waiting for;
- **failure containment**: an answer-fn exception fails only the
  queries in that launch (``Ticket.error`` carries the cause, value
  ``nan``) — it never unwinds through ``pump``/``flush`` and never
  poisons the cache;
- **a circuit breaker** (``breaker_threshold`` consecutive launch
  failures → open): while open, submissions fail fast with
  :class:`CircuitOpenError` instead of queueing work that will fail;
  after ``breaker_reset_s`` one probe launch is allowed (half-open)
  and its outcome closes or re-opens the circuit.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.ft.inject import fault_site
from repro_torch.serve.cache import AnswerCache
from repro_torch.serve.stats import ServiceStats

AnswerFn = Callable[..., object]

#: smallest forced-flush launch shape; partial batches pad up to the
#: next power of two ≥ this, so at most log2(batch/bucket) launch
#: shapes exist besides the full batch
BUCKET_MIN = 16


class ServiceOverloadError(RuntimeError):
    """The admission queue is full — backpressure the caller."""

    def __init__(self, depth: int, max_queue: int):
        super().__init__(
            f"admission queue full ({depth}/{max_queue} pending); "
            "drain/pump the service or raise max_queue")
        self.depth = depth
        self.max_queue = max_queue


class CircuitOpenError(RuntimeError):
    """The circuit breaker is open — the answer fn has failed
    ``breaker_threshold`` consecutive launches; fail fast instead of
    queueing doomed work. Retry after ``retry_in_s``."""

    def __init__(self, retry_in_s: float):
        super().__init__(
            f"service circuit breaker is open (answer fn failing); "
            f"retry in {retry_in_s:.3f}s")
        self.retry_in_s = retry_in_s


class QueryTimeoutError(RuntimeError):
    """A query expired past its ``timeout_s`` budget before its batch
    launched (carried on ``Ticket.error``; raised only by callers that
    choose to)."""


class Ticket:
    """One admitted query's future: ``done`` flips when its batch (or
    cache hit) answers; ``value`` is the f32 distance."""

    __slots__ = ("u", "v", "value", "done", "cached", "error",
                 "t_submit", "t_done")

    def __init__(self, u: int, v: int, t_submit: float):
        self.u = u
        self.v = v
        self.value: Optional[np.float32] = None
        self.done = False
        self.cached = False
        #: None on success; "timeout" / the answer-fn failure string
        #: when this query was failed (value is nan then)
        self.error: Optional[str] = None
        self.t_submit = t_submit
        self.t_done: Optional[float] = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = f"={self.value}" if self.done else " pending"
        if self.error is not None:
            state = f" error={self.error!r}"
        return f"Ticket({self.u},{self.v}{state})"


class QueryService:
    """Continuous-batching query service over an ``answer(u, v)`` fn.

    Parameters
    ----------
    answer:        batched answer callable (`make_answer_fn`).
    batch_size:    kernel launch width; full batches launch eagerly.
    max_queue:     admission bound on pending queries (None = no gate).
    deadline_s:    max time a query waits before a partial batch is
                   forced out by :meth:`pump`.
    cache_size:    hot-pair LRU entries (0 = cache off).
    cache_symmetric: share (u,v)/(v,u) entries (exact for undirected).
    drop_first:    legacy accounting — first launch lands in warmup_s.
    clock:         injectable time source (tests / virtual time).
    timeout_s:     per-query budget; queries older than this at launch
                   time are expired with ``error="timeout"`` (None =
                   no timeout).
    breaker_threshold: consecutive failed launches that open the
                   circuit breaker (0 disables the breaker).
    breaker_reset_s: seconds the breaker stays open before a half-open
                   probe launch is allowed.
    """

    def __init__(self, answer: AnswerFn, *, batch_size: int = 1024,
                 max_queue: Optional[int] = None,
                 deadline_s: float = 0.002,
                 cache_size: int = 0, cache_symmetric: bool = True,
                 drop_first: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 timeout_s: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 30.0):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._answer = answer
        self.batch_size = int(batch_size)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.deadline_s = float(deadline_s)
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self._breaker = "closed"       # closed | open | half-open
        self._breaker_opened_at = 0.0
        self._consec_failures = 0
        self._last_error: Optional[str] = None
        self._cache = (AnswerCache(cache_size, symmetric=cache_symmetric)
                       if cache_size else None)
        self._clock = clock or time.perf_counter
        self._warm = not drop_first
        self.stats_ = ServiceStats()
        # pending queries (admitted, not yet launched), FIFO
        self._pu: List[int] = []
        self._pv: List[int] = []
        self._ptk: List[Ticket] = []
        self._pt: List[float] = []              # enqueue timestamps
        # tickets issued since the last flush(), in submission order
        self._epoch: List[Ticket] = []

    # ------------------------------------------------------- queue

    @property
    def queue_depth(self) -> int:
        return len(self._pu)

    def next_deadline(self) -> Optional[float]:
        """Clock time at which the oldest pending query must launch
        (None when nothing is pending)."""
        if not self._pt:
            return None
        return self._pt[0] + self.deadline_s

    # ------------------------------------------------------ submit

    def try_submit(self, u: int, v: int) -> Optional[Ticket]:
        """Admit one query; ``None`` when the queue is full (the
        open-loop caller counts that as a rejection and moves on).
        Raises :class:`CircuitOpenError` while the breaker is open —
        doomed work is refused at the gate, not queued."""
        now = self._clock()
        if self._breaker == "open":
            waited = now - self._breaker_opened_at
            if waited >= self.breaker_reset_s:
                self._breaker = "half-open"     # admit one probe batch
            else:
                self.stats_.breaker_fast_fails += 1
                raise CircuitOpenError(self.breaker_reset_s - waited)
        u = int(u)
        v = int(v)
        tk = Ticket(u, v, now)
        if self._cache is not None:
            val = self._cache.get(u, v)
            if val is not None:
                tk.value = val
                tk.done = True
                tk.cached = True
                tk.t_done = now
                self.stats_.cache_hits += 1
                self.stats_.queries += 1
                self._epoch.append(tk)
                return tk
            self.stats_.cache_misses += 1
        if self.max_queue is not None and len(self._pu) >= self.max_queue:
            self.stats_.rejected += 1
            return None
        self._pu.append(u)
        self._pv.append(v)
        self._ptk.append(tk)
        self._pt.append(now)
        self._epoch.append(tk)
        self.stats_.admitted += 1
        depth = len(self._pu)
        self.stats_.queue_depth = depth
        if depth > self.stats_.queue_depth_max:
            self.stats_.queue_depth_max = depth
        if depth >= self.batch_size:
            self._launch(self.batch_size, self.batch_size)
        return tk

    def submit(self, u, v) -> List[Ticket]:
        """Admit a query batch (arrays or scalars); raises
        :class:`ServiceOverloadError` on a full queue. Full batches
        launch eagerly as they fill; the tail stays queued (carried)
        until :meth:`pump` hits its deadline or :meth:`flush` drains."""
        uu = np.atleast_1d(np.asarray(u)).astype(np.int64).ravel()
        vv = np.atleast_1d(np.asarray(v)).astype(np.int64).ravel()
        if uu.shape != vv.shape:
            raise ValueError(f"u/v shape mismatch: {uu.shape} vs "
                             f"{vv.shape}")
        out: List[Ticket] = []
        for ui, vi in zip(uu.tolist(), vv.tolist()):
            tk = self.try_submit(ui, vi)
            if tk is None:
                raise ServiceOverloadError(len(self._pu), self.max_queue)
            out.append(tk)
        return out

    # ------------------------------------------------------ launch

    @staticmethod
    def _bucket(k: int, cap: int) -> int:
        """Power-of-two pad target for a forced partial launch."""
        b = BUCKET_MIN
        while b < k:
            b <<= 1
        return min(b, cap)

    def _fail(self, tks: List[Ticket], error: str, now: float) -> None:
        """Resolve tickets as failed: value nan, ``error`` recorded."""
        for tk in tks:
            tk.value = np.float32(np.nan)
            tk.error = error
            tk.done = True
            tk.t_done = now
        self.stats_.failed_queries += len(tks)

    def _launch(self, k: int, pad_to: int) -> None:
        """Answer the oldest ``k`` pending queries in one kernel
        launch padded to ``pad_to`` slots. Expired queries are failed
        instead of launched; an answer-fn exception fails this batch
        only (and feeds the circuit breaker) — it never propagates."""
        start = self._clock()
        tks = self._ptk[:k]
        uu, vv = self._pu[:k], self._pv[:k]
        del self._pu[:k], self._pv[:k], self._ptk[:k], self._pt[:k]
        self.stats_.queue_depth = len(self._pu)
        if self.timeout_s is not None:
            live = [i for i, tk in enumerate(tks)
                    if start - tk.t_submit <= self.timeout_s]
            if len(live) < k:
                expired = [tks[i] for i in range(k)
                           if start - tks[i].t_submit > self.timeout_s]
                self.stats_.timeouts += len(expired)
                self.stats_.queries += len(expired)
                self._fail(expired, "timeout", start)
                tks = [tks[i] for i in live]
                uu = [uu[i] for i in live]
                vv = [vv[i] for i in live]
                k = len(live)
                if k == 0:
                    return
        u = np.asarray(uu, dtype=np.int32)
        v = np.asarray(vv, dtype=np.int32)
        pad = pad_to - k
        if pad:
            u = np.pad(u, (0, pad))
            v = np.pad(v, (0, pad))
        st = self.stats_
        t0 = time.perf_counter()
        try:
            fault_site("serve.answer")
            res = self._answer(torch.from_numpy(u), torch.from_numpy(v))
            res = res.cpu().numpy().astype(np.float32, copy=False)
        except Exception as e:       # a failed launch fails its batch
            #                          only; an InjectedCrash passes
            end = self._clock()
            error = f"{type(e).__name__}: {e}"
            self._last_error = error
            st.answer_failures += 1
            st.batches += 1
            st.queries += k
            self._consec_failures += 1
            tripped = (self.breaker_threshold
                       and (self._breaker == "half-open"
                            or self._consec_failures
                            >= self.breaker_threshold))
            if tripped:
                if self._breaker != "open":
                    st.breaker_trips += 1
                self._breaker = "open"
                self._breaker_opened_at = end
                self._consec_failures = 0
            self._fail(tks, error, end)
            return
        dt = time.perf_counter() - t0
        end = self._clock()
        self._consec_failures = 0
        if self._breaker == "half-open":        # probe succeeded
            self._breaker = "closed"
        st.queries += k
        st.batches += 1
        st.real_slots += k
        st.launched_slots += pad_to
        if self._warm:
            st.busy_s += dt
            st.measured_queries += k
            st.lat_samples.append(dt)
            for tk in tks:
                st.queue_wait_samples.append(start - tk.t_submit)
                st.total_lat_samples.append(end - tk.t_submit)
        else:                          # first batch = compile sample
            st.warmup_s += dt
            self._warm = True
        cache = self._cache
        for i, tk in enumerate(tks):
            val = res[i]
            tk.value = val
            tk.done = True
            tk.t_done = end
            if cache is not None:
                cache.put(tk.u, tk.v, val)

    def pump(self, now: Optional[float] = None) -> int:
        """Fire everything that is *due*: full batches, plus one
        partial batch when the oldest pending query has waited past
        the deadline. Returns queries launched."""
        launched = 0
        while len(self._pu) >= self.batch_size:
            self._launch(self.batch_size, self.batch_size)
            launched += self.batch_size
        if self._pu:
            if now is None:
                now = self._clock()
            if now >= self._pt[0] + self.deadline_s:
                k = len(self._pu)
                self._launch(k, self._bucket(k, self.batch_size))
                launched += k
        return launched

    def drain(self) -> int:
        """Force-launch everything pending; returns queries launched."""
        launched = 0
        while len(self._pu) >= self.batch_size:
            self._launch(self.batch_size, self.batch_size)
            launched += self.batch_size
        if self._pu:
            k = len(self._pu)
            self._launch(k, self._bucket(k, self.batch_size))
            launched += k
        return launched

    # ------------------------------------------------- invalidation

    def invalidate(self, answer: Optional[AnswerFn] = None) -> None:
        """Point the service at a mutated index: drain, then drop
        every cached answer (epoch bump — see
        :meth:`AnswerCache.invalidate`) and optionally swap in the
        rebuilt answer fn.

        Pending queries are launched *before* the swap: they were
        admitted pre-mutation, so they are answered under the labels
        they were admitted against (the batch linearizes before the
        mutation). Everything submitted after this call sees only
        post-mutation answers — a stale cache hit is impossible.
        """
        self.drain()
        if self._cache is not None:
            self._cache.invalidate()
        if answer is not None:
            self._answer = answer
        self.stats_.invalidations += 1

    # ---------------------------------------------------- batch api

    def flush(self) -> np.ndarray:
        """Drain the queue and return the distances for every query
        submitted since the last flush, in submission order (cache
        hits included). Results are NOT retained after being
        returned."""
        self.drain()
        out = np.fromiter((tk.value for tk in self._epoch),
                          dtype=np.float32, count=len(self._epoch))
        self._epoch = []
        return out

    def warmup(self, buckets: bool = False) -> float:
        """Run the full-batch launch shape once (and, with
        ``buckets=True``, every partial-flush bucket shape) outside
        the latency percentiles — the kernel build and first-launch
        costs land here. Returns seconds spent (also recorded
        in ``ServiceStats.warmup_s``)."""
        shapes = [self.batch_size]
        if buckets:
            b = BUCKET_MIN
            while b < self.batch_size:
                shapes.append(b)
                b <<= 1
        t0 = time.perf_counter()
        for s in shapes:
            z = torch.zeros(s, dtype=torch.int32)
            self._answer(z, z).cpu()
        dt = time.perf_counter() - t0
        self.stats_.warmup_s += dt
        self._warm = True
        return dt

    def stats(self) -> dict:
        return self.stats_.summary()

    def health(self) -> dict:
        """Liveness/degradation report for operators and probes.

        ``status``: ``"ok"`` (everything answering), ``"degraded"``
        (answers flow but faults occurred — failed launches, expired
        queries, or quarantined shards), ``"unavailable"`` (breaker
        open: submissions fail fast). Quarantined shards come from the
        routed answer fn when it tracks them
        (:class:`repro_torch.serve.routing.RoutedAnswer`)."""
        now = self._clock()
        st = self.stats_
        quarantined = dict(getattr(self._answer, "quarantined", None) or {})
        retry_in = 0.0
        if self._breaker == "open":
            retry_in = max(0.0, self.breaker_reset_s
                           - (now - self._breaker_opened_at))
        if self._breaker == "open" and retry_in > 0:
            status = "unavailable"
        elif (quarantined or st.answer_failures or st.timeouts
                or self._breaker != "closed"):
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "breaker": self._breaker,
            "breaker_retry_in_s": retry_in,
            "consecutive_failures": self._consec_failures,
            "answer_failures": st.answer_failures,
            "failed_queries": st.failed_queries,
            "timeouts": st.timeouts,
            "breaker_trips": st.breaker_trips,
            "breaker_fast_fails": st.breaker_fast_fails,
            "queue_depth": len(self._pu),
            "last_error": self._last_error,
            "quarantined_shards": quarantined,
        }

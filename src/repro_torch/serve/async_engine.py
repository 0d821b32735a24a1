"""Async micro-batching serving tier over ``GNNInferenceEngine``
(DESIGN.md §11).

The port's copy of ``repro.serve.async_engine``, unchanged but for its
imports and one repair: ``snapshot`` reads each tenant's engine under the
tenant's lock. The tier only schedules: each tenant is a port
``GNNInferenceEngine`` on its own device, and with ``start=True`` the
worker thread runs their forwards (and so launches the CUDA kernels).

The paper's 130x inference speedup comes from precomputed batches; the
synchronous ``GNNInferenceEngine`` (§8) only coalesces requests that arrive
inside ONE ``run`` call. This tier makes coalescing continuous across a
live request stream:

* **Bounded queue** — ``submit`` is non-blocking; beyond ``max_queue``
  in-flight requests admission rejects on arrival (backpressure, never
  unbounded memory).
* **Micro-batching window** — pending requests are dispatched as one
  coalesced ``GNNInferenceEngine.run`` when EITHER a full batch's worth of
  distinct routed rows accumulates for some precomputed batch (the plan's
  ``batch_occupancy`` hint: waiting longer cannot pack more work into that
  batch's forward) OR the oldest pending request has waited ``window_us``.
* **Deadline-aware admission** — a request carrying ``deadline_ms`` is
  rejected on arrival when the queue's drain estimate (EWMA of observed
  per-request service time × depth + one window) already exceeds it;
  admitted requests whose deadline passes while queued expire at dispatch
  time instead of wasting a forward.
* **Multi-tenant dispatch** — several ``(plan, params)`` tenants (each its
  own ``GNNInferenceEngine``, LRU and version chain) behind one queue and
  one worker. ``swap(tenant, plan, delta)`` hot-swaps ONE tenant atomically
  against its in-flight window without draining anyone's queue (§10's
  version chain per tenant).
* **Fault isolation** — a tenant forward that raises fails exactly that
  window's futures; the worker keeps serving other tenants (and the faulty
  tenant's next window).
* **Graceful degradation** (DESIGN.md §12, all opt-in via config) —
  bounded retry-with-backoff absorbs transient forward faults; a per-tenant
  circuit breaker opens after N consecutive window failures (fast-reject
  with retry-after, half-open probe to recover); a watchdog restarts a
  crashed worker loop after ``step`` has failed — never hung — its
  in-flight futures. All of it drivable deterministically by a seeded
  ``repro_torch.faults.FaultInjector`` (``faults=``) and observable through
  ``fault_stats`` / ``snapshot()["faults"]``.

Determinism discipline: all timing flows through an injectable clock and
the dispatcher is a reentrant ``step()``; tests drive scripted arrival
traces against a fake clock with no worker thread and no sleeps
(``tests/test_torch_async.py``), while production uses ``start=True`` for
the condition-variable worker loop. Shutdown mirrors the ``PrefetchLoader``
Event/sentinel fix: ``close()`` flushes pending windows, completes every
future, and joins the worker.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.faults import NO_FAULTS, FaultStats, WorkerDeath
from repro_torch.serve.common import (
    CircuitBreaker, ServeClosed, ServeError, ServeExpired, ServeFuture,
    ServeRejected, ServeUnavailable, SystemClock)
from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest


@dataclasses.dataclass(frozen=True)
class AsyncServeConfig:
    """Window/admission policy knobs (DESIGN.md §11).

    ``max_requests_per_window=1`` degrades the tier to request-at-a-time
    dispatch — the A/B baseline the sustained-load bench beats.

    The degradation knobs (DESIGN.md §12) default OFF so the healthy-path
    behavior — and every pre-existing test — is bit-identical:
    ``max_retries=0`` fails a window on its first forward error exactly as
    before, and ``breaker_threshold=0`` disables the per-tenant circuit
    breaker entirely."""

    window_us: float = 2000.0            # max coalescing wait for a request
    max_queue: int = 1024                # bounded queue: reject beyond this
    max_requests_per_window: Optional[int] = None   # None = drain the window
    occupancy_dispatch: bool = True      # fire early on a full batch's worth
    service_time_init_us: float = 500.0  # drain-estimate seed per request
    ewma_alpha: float = 0.2              # service-time estimator smoothing
    latency_window: int = 4096           # completed-latency ring for pXX
    # graceful degradation (DESIGN.md §12) — all off by default
    max_retries: int = 0                 # window forward retries (transient)
    retry_backoff_us: float = 100.0      # backoff base, doubles per attempt
    breaker_threshold: int = 0           # consecutive window failures → open
    breaker_cooldown_us: float = 50_000.0   # open → half-open probe delay


class ServeStats:
    """Counters + latency ring of the serving tier — everything admission
    control and the load bench observe. Mutated only under the engine lock;
    ``snapshot()`` returns a consistent dict including p50/p95/p99."""

    COUNTERS = ("submitted", "accepted", "rejected_full", "rejected_deadline",
                "rejected_unroutable", "rejected_unavailable", "expired",
                "completed", "failed", "window_errors", "windows")

    def __init__(self, latency_window: int):
        for k in self.COUNTERS:
            setattr(self, k, 0)
        self.queue_depth = 0
        self.window_occupancy = 0.0      # last window: rows / batch capacity
        self._window_requests_sum = 0
        self._lat_us: deque = deque(maxlen=latency_window)

    @property
    def rejected(self) -> int:
        return (self.rejected_full + self.rejected_deadline +
                self.rejected_unroutable + self.rejected_unavailable)

    def record_window(self, n_requests: int, occupancy: float) -> None:
        self.windows += 1
        self._window_requests_sum += n_requests
        self.window_occupancy = occupancy

    def snapshot(self) -> Dict:
        d = {k: getattr(self, k) for k in self.COUNTERS}
        d["rejected"] = self.rejected
        d["queue_depth"] = self.queue_depth
        d["window_occupancy"] = self.window_occupancy
        d["mean_window_requests"] = (
            self._window_requests_sum / self.windows if self.windows else 0.0)
        if self._lat_us:
            lat = np.asarray(self._lat_us)
            d["p50_us"], d["p95_us"], d["p99_us"] = (
                float(np.percentile(lat, p)) for p in (50, 95, 99))
        return d


@dataclasses.dataclass
class _Pending:
    """One admitted request waiting in a tenant's window."""
    fut: ServeFuture
    node_ids: np.ndarray
    bidx: np.ndarray                     # routed batch per queried node
    rows: np.ndarray                     # routed row per queried node
    deadline_ms: Optional[float]
    t_submit: float


class _Tenant:
    """One ``(plan, params)`` model behind the shared queue: its own
    ``GNNInferenceEngine`` (LRU, stats, version chain), pending window, and
    a lock that makes ``swap`` atomic against its in-flight dispatch."""

    def __init__(self, name: str, engine: GNNInferenceEngine,
                 breaker: Optional[CircuitBreaker] = None):
        self.name = name
        self.engine = engine
        self.lock = threading.Lock()
        self.occupancy = engine.plan.batch_occupancy()
        self.pending: List[_Pending] = []
        self.full = False                # some batch's worth accumulated
        self.swaps = 0
        self.breaker = breaker           # None = breaker disabled (§12)

    def oldest_t(self) -> Optional[float]:
        return self.pending[0].t_submit if self.pending else None

    def note_pending_rows(self, occupancy_dispatch: bool,
                          max_rpw: Optional[int]) -> None:
        """Recompute the full-batch flag from the pending set (called after
        admission and after a partial take)."""
        if max_rpw is not None and len(self.pending) >= max_rpw:
            self.full = True
            return
        if not occupancy_dispatch:
            self.full = False
            return
        per_batch: Dict[int, set] = {}
        for p in self.pending:
            for bi, r in zip(p.bidx, p.rows):
                per_batch.setdefault(int(bi), set()).add(int(r))
        self.full = any(
            bi < len(self.occupancy) and 0 < self.occupancy[bi] <= len(rows)
            for bi, rows in per_batch.items())


class AsyncGNNEngine:
    """Micro-batching async serving tier (DESIGN.md §11).

    ``tenants`` maps name → a constructed :class:`GNNInferenceEngine` (the
    tenant owns its plan/params/LRU). ``submit`` returns a
    :class:`ServeFuture` immediately — rejected requests come back as an
    already-failed future (``fut.rejected``), admitted ones complete when
    their window runs. With ``start=True`` a worker thread drives dispatch;
    with ``start=False`` the caller (tests, schedulers) pumps ``step()``.
    """

    def __init__(self, tenants: Dict[str, GNNInferenceEngine],
                 config: Optional[AsyncServeConfig] = None,
                 clock=None, start: bool = True, faults=None):
        if not tenants:
            raise ValueError("AsyncGNNEngine needs at least one tenant")
        self.cfg = config or AsyncServeConfig()
        self._clock = clock or SystemClock()
        self.faults = faults or NO_FAULTS
        self.fault_stats = FaultStats(
            "retries", "fast_rejects", "worker_restarts", "breaker_opens",
            "breaker_closes", "swap_rollbacks")
        mk_breaker = (lambda: CircuitBreaker(
            self.cfg.breaker_threshold, self.cfg.breaker_cooldown_us / 1e6)
        ) if self.cfg.breaker_threshold > 0 else (lambda: None)
        self._tenants = {name: _Tenant(name, eng, mk_breaker())
                         for name, eng in tenants.items()}
        self._cond = threading.Condition()
        self._closed = False
        self.stats = ServeStats(self.cfg.latency_window)
        self._svc_us = float(self.cfg.service_time_init_us)
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._worker_main, name="async-gnn-dispatch",
                daemon=True)
            self._thread.start()

    def _sleep(self, seconds: float) -> None:
        """Backoff/stall through the injectable clock: a FakeClock's
        ``sleep`` just advances time, keeping fault tests sleep-free."""
        if seconds > 0:
            sleep = getattr(self._clock, "sleep", None)
            if sleep is not None:
                sleep(seconds)

    # -------------------------------------------------------------- submit
    def submit(self, tenant: str, node_ids: Sequence[int],
               deadline_ms: Optional[float] = None) -> ServeFuture:
        """Route + admit one request; never blocks on compute.

        Admission (in order): closed engine raises :class:`ServeClosed`;
        a full queue, an infeasible ``deadline_ms`` (drain estimate), or
        ids the tenant's CURRENT plan cannot route come back as an
        already-rejected future. The routing done here is an occupancy
        *hint* — the authoritative routing happens inside the dispatched
        ``GNNInferenceEngine.run``, so requests admitted before a ``swap``
        are served by the post-swap plan version."""
        t = self._tenants[tenant]
        now = self._clock.now()
        fut = ServeFuture(tenant, now)
        q = np.asarray(node_ids, dtype=np.int64).ravel()
        with self._cond:
            if self._closed:
                raise ServeClosed("submit after close()")
            self.stats.submitted += 1
            if t.breaker is not None:
                ok, retry_after = t.breaker.allow(now)
                if not ok:
                    # circuit open (DESIGN.md §12): O(1) fast-reject with a
                    # retry-after hint instead of queueing doomed work
                    self.stats.rejected_unavailable += 1
                    self.fault_stats.bump("fast_rejects")
                    fut.finish(exc=ServeUnavailable(
                        f"tenant {tenant!r} circuit open after "
                        f"{t.breaker.consecutive_failures} consecutive "
                        f"window failures; retry after "
                        f"{retry_after * 1e3:.1f}ms",
                        retry_after_ms=retry_after * 1e3), t_done=now)
                    return fut
            if self.stats.queue_depth >= self.cfg.max_queue:
                self.stats.rejected_full += 1
                fut.finish(exc=ServeRejected(
                    f"queue full ({self.cfg.max_queue} in flight)"),
                    t_done=now)
                return fut
            try:
                bidx, rows = t.engine.plan.routing.lookup(q)
            except KeyError as e:
                self.stats.rejected_unroutable += 1
                fut.finish(exc=ServeRejected(str(e)), t_done=now)
                return fut
            if deadline_ms is not None:
                est_ms = self._drain_estimate_us() / 1e3
                if est_ms > deadline_ms:
                    self.stats.rejected_deadline += 1
                    fut.finish(exc=ServeRejected(
                        f"deadline {deadline_ms:.1f}ms infeasible: drain "
                        f"estimate {est_ms:.1f}ms at depth "
                        f"{self.stats.queue_depth}"), t_done=now)
                    return fut
            t.pending.append(_Pending(fut, q, bidx, rows, deadline_ms, now))
            self.stats.accepted += 1
            self.stats.queue_depth += 1
            t.note_pending_rows(self.cfg.occupancy_dispatch,
                                self.cfg.max_requests_per_window)
            self._cond.notify_all()
        return fut

    def _drain_estimate_us(self) -> float:
        """Serve-by estimate for a request admitted NOW: everything queued
        ahead of it plus itself at the observed per-request service rate,
        plus one coalescing window of wait."""
        return ((self.stats.queue_depth + 1) * self._svc_us +
                self.cfg.window_us)

    # ------------------------------------------------------------ dispatch
    def _ready(self, t: _Tenant, now: float) -> bool:
        if not t.pending:
            return False
        if t.full:
            return True
        return (now - t.pending[0].t_submit) * 1e6 >= self.cfg.window_us

    def _take(self, t: _Tenant) -> List[_Pending]:
        """Pop one window's worth of this tenant's pending requests
        (caller holds the lock)."""
        k = len(t.pending) if self.cfg.max_requests_per_window is None \
            else min(len(t.pending), self.cfg.max_requests_per_window)
        chunk, t.pending = t.pending[:k], t.pending[k:]
        self.stats.queue_depth -= len(chunk)
        t.note_pending_rows(self.cfg.occupancy_dispatch,
                            self.cfg.max_requests_per_window)
        return chunk

    def step(self, now: Optional[float] = None, force: bool = False) -> int:
        """One dispatcher iteration: run every tenant whose window is ready
        (or, with ``force``, every tenant with pending work). Returns the
        number of requests dispatched or terminally resolved. Reentrant —
        the worker loop calls exactly this; tests call it directly.

        Crash-safe (DESIGN.md §12): windows popped off the queue are
        IN-FLIGHT — if the dispatcher dies between take and dispatch (the
        ``worker_death`` injection point, or any unexpected error escaping
        ``_dispatch``), every in-flight future is FAILED with that error
        before the exception propagates to the watchdog. A crashed worker
        may lose a window's work, never a future's completion."""
        now = self._clock.now() if now is None else now
        taken: List[Tuple[_Tenant, List[_Pending]]] = []
        with self._cond:
            for t in self._tenants.values():
                if t.pending and (force or self._ready(t, now)):
                    taken.append((t, self._take(t)))
        n = 0
        inflight = deque(taken)
        try:
            self.faults.fire("worker_death", WorkerDeath)
            while inflight:
                t, chunk = inflight[0]
                n += self._dispatch(t, chunk, now)
                inflight.popleft()
            return n
        except BaseException as e:
            failed = 0
            for t, chunk in inflight:    # fail, never hang, every in-flight
                for p in chunk:          # future (finish is one-shot, so
                    if p.fut.finish(exc=e, t_done=now):   # partially-
                        failed += 1      # dispatched windows are safe)
            with self._cond:
                self.stats.failed += failed
            raise

    def _dispatch(self, t: _Tenant, chunk: List[_Pending],
                  now: float) -> int:
        # deadline expiry while queued: fail, never waste the forward
        live: List[_Pending] = []
        for p in chunk:
            if p.deadline_ms is not None and \
                    (now - p.t_submit) * 1e3 > p.deadline_ms:
                with self._cond:
                    self.stats.expired += 1
                p.fut.finish(exc=ServeExpired(
                    f"deadline {p.deadline_ms:.1f}ms passed after "
                    f"{(now - p.t_submit) * 1e3:.1f}ms in queue"),
                    t_done=now)
                continue
            live.append(p)
        if not live:
            return len(chunk)
        # window occupancy: distinct routed rows vs the capacity of the
        # batches this window touches (1.0 = the forwards are full)
        per_batch: Dict[int, set] = {}
        for p in live:
            for bi, r in zip(p.bidx, p.rows):
                per_batch.setdefault(int(bi), set()).add(int(r))
        capacity = sum(int(t.occupancy[bi]) for bi in per_batch
                       if bi < len(t.occupancy))
        occ = (sum(len(v) for v in per_batch.values()) / capacity
               if capacity else 0.0)
        reqs = [GNNRequest(node_ids=p.node_ids) for p in live]
        stall = self.faults.delay("dispatch_delay")
        if stall:
            self._sleep(stall)
        t0 = self._clock.now()
        attempt = 0
        while True:
            try:
                with t.lock:             # atomic against swap(tenant, ...)
                    self.faults.fire("forward")
                    # by design: the per-tenant lock EXISTS to serialize
                    # engine.run against swap — only this tenant's
                    # traffic waits, and the window is the unit of work
                    t.engine.run(reqs)   # lint: allow(lock-blocking)
                break
            except Exception as e:
                if attempt < self.cfg.max_retries:
                    # transient-fault absorption (DESIGN.md §12): bounded
                    # retry with exponential backoff through the clock
                    attempt += 1
                    with self._cond:
                        self.fault_stats.bump("retries")
                    self._sleep(self.cfg.retry_backoff_us
                                * (2 ** (attempt - 1)) / 1e6)
                    continue
                # retries exhausted — fault isolation: fail ONLY this
                t_done = self._clock.now()   # window; keep serving every
                with self._cond:             # tenant (including this one)
                    self.stats.window_errors += 1
                    self.stats.failed += len(live)
                    self.stats.record_window(len(live), occ)
                    if t.breaker is not None and \
                            t.breaker.record_failure(t_done):
                        self.fault_stats.bump("breaker_opens")
                for p in live:
                    p.fut.finish(exc=e, t_done=t_done)
                return len(chunk)
        t_done = self._clock.now()
        with self._cond:
            if t.breaker is not None:
                was = t.breaker.state
                t.breaker.record_success(t_done)
                if was != CircuitBreaker.CLOSED:
                    self.fault_stats.bump("breaker_closes")
            obs_us = (t_done - t0) * 1e6 / len(live)
            a = self.cfg.ewma_alpha
            self._svc_us = (1 - a) * self._svc_us + a * obs_us
            self.stats.record_window(len(live), occ)
            for p, r in zip(live, reqs):
                if r.error is not None:
                    self.stats.failed += 1
                else:
                    self.stats.completed += 1
                    self.stats._lat_us.append((t_done - p.t_submit) * 1e6)
        for p, r in zip(live, reqs):
            if r.error is not None:
                p.fut.finish(exc=ServeError(r.error), t_done=t_done)
            else:
                p.fut.finish(value=r.logits, t_done=t_done)
        return len(chunk)

    # --------------------------------------------------------- worker loop
    def _wait_timeout(self, now: float) -> Optional[float]:
        """Seconds until the oldest pending window expires; None when the
        queue is empty (sleep until submit notifies)."""
        oldest = [t.oldest_t() for t in self._tenants.values()
                  if t.pending]
        if not oldest:
            return None
        remain = self.cfg.window_us / 1e6 - (now - min(oldest))
        return max(remain, 1e-4)

    def _worker_main(self) -> None:
        """Watchdog shell around the dispatch loop (DESIGN.md §12): a
        crashed worker loop — injected ``worker_death`` or a genuine bug —
        has already FAILED its in-flight futures (``step`` guarantees it),
        so the watchdog just counts the restart and re-enters the loop.
        Queued-but-not-taken requests survive the crash untouched and are
        served by the restarted loop."""
        while True:
            try:
                self._worker_loop()
                return                   # clean exit: close() was called
            except BaseException:
                with self._cond:
                    self.fault_stats.bump("worker_restarts")
                    if self._closed:     # crashed during the close-path
                        break            # flush: drain below, then exit
        self._drain_all()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed:
                    now = self._clock.now()
                    if any(self._ready(t, now)
                           for t in self._tenants.values()):
                        break
                    self._cond.wait(self._wait_timeout(now))
                if self._closed:
                    break
            self.step()
        self._drain_all()                # complete every admitted future

    def flush(self) -> int:
        """Dispatch every pending window regardless of readiness (close
        path; also useful to drain deterministically in tests)."""
        n = 0
        while True:
            got = self.step(force=True)
            if not got:
                return n
            n += got

    def _drain_all(self, max_crashes: int = 10) -> None:
        """Close-path drain that terminates even under a fault storm:
        ``flush`` is retried through worker crashes (each crash already
        failed its in-flight futures); after ``max_crashes`` consecutive
        crashes whatever is still queued is failed with ServeClosed. Either
        way, EVERY admitted future terminates (DESIGN.md §12)."""
        for _ in range(max_crashes):
            try:
                self.flush()
                return
            except BaseException:
                with self._cond:
                    self.fault_stats.bump("worker_restarts")
        now = self._clock.now()
        failed = 0
        with self._cond:
            for t in self._tenants.values():
                for p in t.pending:
                    if p.fut.finish(exc=ServeClosed(
                            "engine closed during a fault storm; request "
                            "was never dispatched"), t_done=now):
                        failed += 1
                self.stats.queue_depth -= len(t.pending)
                t.pending = []
                t.full = False
            self.stats.failed += failed

    def close(self) -> None:
        """Clean shutdown: stop admission, flush pending windows (every
        admitted future completes — with a result, its tenant's error, or
        expiry), join the worker. Idempotent."""
        with self._cond:
            already = self._closed
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        elif not already:
            self._drain_all()

    def __enter__(self) -> "AsyncGNNEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- tenants
    def swap(self, tenant: str, plan, delta=None) -> Dict[str, int]:
        """Hot-swap ONE tenant onto a refreshed plan (§10 version chain)
        without draining the queue: the tenant lock serializes the swap
        against that tenant's in-flight window only — other tenants keep
        dispatching, and this tenant's queued requests are served by the
        NEW plan version at their window (dispatch re-routes).

        A swap the engine REFUSES (invalid/corrupt plan, mismatched audit —
        DESIGN.md §12) raises out of here with the tenant untouched: it
        keeps serving the parent plan version, its occupancy hint and LRU
        intact, and the rollback is counted in ``fault_stats`` plus the
        engine's own ``swap_audit`` trail."""
        t = self._tenants[tenant]
        try:
            with t.lock:
                # by design: zero-downtime swap is "atomic between
                # windows" — the same per-tenant lock that serializes
                # run() must cover the validate+swap, or a window could
                # run mid-swap on a half-installed plan
                res = t.engine.swap(plan, delta)   # lint: allow(lock-blocking)
                t.occupancy = t.engine.plan.batch_occupancy()
        except Exception:
            with self._cond:
                self.fault_stats.bump("swap_rollbacks")
            raise
        with self._cond:
            t.swaps += 1
        return res

    def tenant_engine(self, tenant: str) -> GNNInferenceEngine:
        return self._tenants[tenant].engine

    # --------------------------------------------------------------- stats
    def snapshot(self) -> Dict:
        """Consistent ``ServeStats`` view plus per-tenant serving counters
        (the §10 per-version tables ride along unchanged) and the fault
        surface (DESIGN.md §12): degradation counters, per-tenant breaker
        state, and — when an injector is attached — what it injected.

        Each tenant's engine counters are read under that tenant's lock,
        the lock its window holds around ``engine.run``, so a snapshot
        waits for a window in flight instead of iterating an out-of-core
        LRU the window is changing (the reference reads them under
        ``_cond`` alone and can raise ``OrderedDict mutated during
        iteration``). The tenant locks are taken one at a time and never
        with ``_cond`` held, as ``_dispatch`` and ``swap`` take them, so no
        lock order can deadlock."""
        engines = {}
        for name, t in self._tenants.items():
            with t.lock:
                # out-of-core tenants also report lazy-cache
                # faulting/eviction/IO counters (DESIGN.md §13)
                engines[name] = (copy.deepcopy(t.engine.stats),
                                 t.engine.ooc_stats())
        with self._cond:
            d = self.stats.snapshot()
            d["service_estimate_us"] = self._svc_us
            d["tenants"] = {
                name: {"swaps": t.swaps, "pending": len(t.pending),
                       "engine": engines[name][0],
                       "ooc": engines[name][1],
                       "breaker": (t.breaker.snapshot()
                                   if t.breaker is not None else None)}
                for name, t in self._tenants.items()}
            d["faults"] = self.fault_stats.snapshot()
            if self.faults.active:
                d["faults"]["injected"] = self.faults.snapshot()
        return d

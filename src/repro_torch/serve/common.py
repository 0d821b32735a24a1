"""Shared serving-tier machinery (DESIGN.md §11).

The LM ``ServeEngine`` (slot-based continuous batching) and the GNN
``AsyncGNNEngine`` (micro-batching windows over ``GNNInferenceEngine``)
share one lifecycle vocabulary:

* a **clock** — all timing goes through an injectable ``now()`` source so
  every window/deadline behavior is testable with a fake clock instead of
  wall-clock sleeps (the same determinism discipline as the
  ``PrefetchLoader`` Event/sentinel shutdown);
* a **future** — completion is signaled through a ``threading.Event``-backed
  :class:`ServeFuture`, never by polling;
* a **slot pool** — fixed-capacity admission with busy-rejection and
  immediate slot reuse on completion (:class:`SlotPool`), the unit the LM
  engine's continuous batching and its tests are written against.
"""
from __future__ import annotations

import threading
import time
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


class SystemClock:
    """Default clock: monotonic seconds. The serving tier only ever
    compares differences of ``now()``, so any monotonic origin works —
    which is exactly what lets tests substitute a manually-advanced fake.
    ``sleep`` rides along for the same reason: retry backoff
    (DESIGN.md §12) waits through the clock, so a fake clock's ``sleep``
    can simply advance time and tests stay sleep-free."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class ServeError(RuntimeError):
    """Base class for serving-tier request failures."""


class ServeRejected(ServeError):
    """Admission control refused the request on arrival (queue full,
    deadline infeasible, or ids not routable under the current plan)."""


class ServeExpired(ServeError):
    """The request was admitted but its deadline passed while queued."""


class ServeUnavailable(ServeRejected):
    """Fast-reject because the tenant's circuit breaker is OPEN
    (DESIGN.md §12): the tenant has failed ``threshold`` consecutive
    windows and is cooling down. ``retry_after_ms`` tells the client when
    the breaker will admit a half-open probe — the graceful-degradation
    contract: shed load in O(1) instead of queueing work that will fail."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class ServeClosed(ServeError):
    """The engine was closed; no further requests are accepted."""


class ServeFuture:
    """Event-backed completion handle for one submitted request.

    ``result(timeout)`` blocks on the event (no polling) and either returns
    the value or raises the recorded exception — :class:`ServeRejected` /
    :class:`ServeExpired` / :class:`ServeClosed` for lifecycle failures, or
    whatever a faulty tenant forward raised (fault isolation: the error of
    ONE window must reach exactly that window's futures)."""

    def __init__(self, tenant: str = "", t_submit: float = 0.0):
        self.tenant = tenant
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self._ev = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    # ------------------------------------------------------------ producer
    def finish(self, value=None, exc: Optional[BaseException] = None,
               t_done: Optional[float] = None) -> bool:
        """Complete the future (one-shot). Returns True when THIS call
        completed it — the watchdog path uses this to count how many
        in-flight futures it actually failed (DESIGN.md §12)."""
        if self._ev.is_set():            # completion is one-shot
            return False
        self._value, self._exc, self.t_done = value, exc, t_done
        self._ev.set()
        return True

    # ------------------------------------------------------------ consumer
    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request not complete")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request not complete")
        return self._exc

    @property
    def rejected(self) -> bool:
        return isinstance(self._exc, ServeRejected)

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


class SlotPool(Generic[T]):
    """Fixed pool of serving slots: acquire → occupy → release.

    The admission contract the LM engine's tests pin: ``acquire`` returns
    the FIRST free slot index (so reuse after a mid-stream completion lands
    in the vacated slot) or None while all slots are busy — no silent
    queueing, no eviction. ``release_all`` is the shutdown/exhaustion path:
    it empties every slot and returns the evicted occupants so the caller
    can account for them (slot state must never leak past the stream that
    created it)."""

    def __init__(self, num_slots: int):
        self._slots: List[Optional[T]] = [None] * num_slots

    def __len__(self) -> int:
        return len(self._slots)

    def __getitem__(self, i: int) -> Optional[T]:
        return self._slots[i]

    def __iter__(self):
        return iter(self._slots)

    @property
    def slots(self) -> List[Optional[T]]:
        return self._slots

    @property
    def free_count(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def acquire(self, item: T) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                self._slots[i] = item
                return i
        return None

    def release(self, i: int) -> Optional[T]:
        item, self._slots[i] = self._slots[i], None
        return item

    def release_all(self) -> List[T]:
        evicted = [s for s in self._slots if s is not None]
        self._slots = [None] * len(self._slots)
        return evicted


class CircuitBreaker:
    """Per-tenant circuit breaker over micro-batching windows
    (DESIGN.md §12).

    State machine (all transitions driven by the injectable clock, so the
    full lifecycle is testable against a FakeClock with zero sleeps)::

        CLOSED --[threshold consecutive window failures]--> OPEN
        OPEN   --[cooldown_s elapsed, next allow()]-------> HALF_OPEN
        HALF_OPEN --[window succeeds]--> CLOSED
        HALF_OPEN --[window fails]-----> OPEN   (cooldown restarts)

    While OPEN, ``allow`` returns ``(False, retry_after_s)`` and the tier
    fast-rejects with :class:`ServeUnavailable` — a wedged tenant sheds its
    load in O(1) instead of queueing requests its forwards will fail, and
    other tenants behind the same queue are untouched. The half-open probe
    is how a recovered tenant re-earns traffic: ONE window is admitted and
    its outcome decides. Any window success resets the consecutive-failure
    count (the breaker counts *consecutive* failures, not a failure rate).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int, cooldown_s: float):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1: {threshold}")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.opens = 0
        self.closes = 0

    def allow(self, now: float) -> "tuple[bool, float]":
        """(admit?, retry_after_s). Transitions OPEN → HALF_OPEN when the
        cooldown has elapsed (the caller's admission IS the probe)."""
        if self.state == self.OPEN:
            waited = now - self.opened_at
            if waited < self.cooldown_s:
                return False, self.cooldown_s - waited
            self.state = self.HALF_OPEN
        return True, 0.0

    def record_success(self, now: float) -> None:
        self.consecutive_failures = 0
        if self.state != self.CLOSED:
            self.state = self.CLOSED
            self.closes += 1

    def record_failure(self, now: float) -> bool:
        """Record one window failure; True when this failure OPENED the
        breaker (a half-open probe failure re-opens immediately)."""
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN or (
                self.state == self.CLOSED
                and self.consecutive_failures >= self.threshold):
            self.state = self.OPEN
            self.opened_at = now
            self.opens += 1
            return True
        return False

    def snapshot(self) -> dict:
        return {"state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "opens": self.opens, "closes": self.closes}

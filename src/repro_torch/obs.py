"""Spans and counters at the port's layer boundaries, on the device trace's
clock (DESIGN.md §16).

    from repro_torch import obs
    with obs.span("plan.cache") as s:
        cache = BatchCache(batches)
        s.add(bytes=cache.nbytes())
    s.seconds                        # the span's duration, once closed

A span records its name, start and end, its parent (the innermost span
open in its thread, or the ``parent=`` a worker thread's creator hands it,
``obs.current()``), its thread, its identifiers (keyword arguments at open:
``epoch``, ``step``, ``batch``, ``run``; a child inherits its parent's) and
its counts (``add``: ``bytes``, ``steps``).

* **Totals are always on**: per name the number of spans, their seconds
  and their summed counts (``totals()``), measured on ``perf_counter_ns``.
  ``Plan.timings`` is read from the plan build's spans.
* **Records are kept only while tracing**: while a ``torch.profiler``
  profile collects, or between ``enable()`` and ``disable()``. Up to
  ``RECORD_CAP`` records are kept in memory (``records()``); past it
  ``dropped()`` counts what was lost.
* A record's ``start_ns`` and ``end_ns`` are on the Unix clock
  (``time.time_ns``), the clock Kineto stamps the profiler's host events
  with, so a worker thread's spans, which the profiler does not see, line
  up with the device timeline. While a profiler collects in the span's own
  thread, the span also enters ``torch.profiler.record_function(name)``,
  and the trace carries the program's names.

Readers take ``snapshot()`` in-process; nothing is written to a file.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: the most records kept; later ones are counted by ``dropped()``
RECORD_CAP = 200_000

_lock = threading.Lock()
_totals: Dict[str, Dict[str, float]] = {}
_records: List[tuple] = []
_dropped = 0
_cap = RECORD_CAP
_enabled = False
_ids = itertools.count(1)
_local = threading.local()


def tracing() -> bool:
    """Whether spans are recorded now: after ``enable()``, or while a
    ``torch.profiler`` profile collects (in any thread)."""
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Record every span from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler collects."""
    global _enabled
    _enabled = False


def reset(cap: int = RECORD_CAP) -> None:
    """Forget every total and record; keep at most ``cap`` records."""
    global _dropped, _cap
    with _lock:
        _totals.clear()
        _records.clear()
        _dropped, _cap = 0, cap


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current() -> Optional["Span"]:
    """The innermost recorded span open in this thread: what a thread hands
    a worker it starts, as the worker's spans' ``parent``."""
    st = _stack()
    return st[-1] if st else None


class Span:
    """One span; open it with ``with``. ``add`` sums counts into it;
    ``seconds`` is its duration once closed."""

    __slots__ = ("name", "ids", "counts", "id", "parent", "seconds",
                 "_t0", "_start_ns", "_rf", "_traced")

    def __init__(self, name: str, parent: Optional["Span"], ids: Dict):
        self.name, self.parent, self.ids = name, parent, ids
        self.counts: Optional[Dict[str, int]] = None
        self.id = 0
        self.seconds = 0.0
        self._traced = False
        self._rf = None

    def add(self, **counts) -> None:
        if self.counts is None:
            self.counts = {}
        for k, v in counts.items():
            if k in ("count", "seconds"):
                raise ValueError(f"a span count may not be named {k!r}")
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self) -> "Span":
        if tracing():
            self._traced = True
            st = _stack()
            if self.parent is None and st:
                self.parent = st[-1]
            if self.parent is not None:
                self.ids = {**self.parent.ids, **self.ids}
            self.id = next(_ids)
            st.append(self)
            if torch.autograd._profiler_enabled():
                self._rf = _profiler.record_function(self.name)
                self._rf.__enter__()
            self._start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        dt = time.perf_counter_ns() - self._t0
        self.seconds = dt * 1e-9
        if self._traced:
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            _stack().pop()
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = {"count": 0, "seconds": 0.0}
            tot["count"] += 1
            tot["seconds"] += self.seconds
            if self.counts:
                for k, v in self.counts.items():
                    tot[k] = tot.get(k, 0) + v
            if self._traced:
                if len(_records) < _cap:
                    _records.append((
                        self.name, self.id,
                        (self.parent.id or None) if self.parent else None,
                        threading.current_thread().name, self._start_ns,
                        self._start_ns + dt,
                        {**self.ids, **(self.counts or {})}))
                else:
                    _dropped += 1


def span(name: str, parent: Optional[Span] = None, **ids) -> Span:
    """A span named ``name`` with identifiers ``ids``; its parent is
    ``parent`` (a span of another thread) or this thread's innermost open
    recorded span."""
    return Span(name, parent, ids)


_FIELDS = ("name", "id", "parent", "thread", "start_ns", "end_ns", "attrs")


def snapshot() -> Dict:
    """``totals``, ``records`` and ``dropped`` at one moment."""
    with _lock:
        tot = {k: dict(v) for k, v in _totals.items()}
        rows, lost = list(_records), _dropped
    return {"totals": tot, "records": [dict(zip(_FIELDS, r)) for r in rows],
            "dropped": lost}


def totals() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``seconds`` and each summed count."""
    return snapshot()["totals"]


def records() -> List[Dict]:
    """The recorded spans in the order they closed, each a dict of
    ``name``, ``id``, ``parent`` (an id or None), ``thread``, ``start_ns``,
    ``end_ns`` (Unix clock) and ``attrs`` (identifiers and counts)."""
    return snapshot()["records"]


def dropped() -> int:
    """Records lost to the cap since the last ``reset``."""
    return _dropped

"""Deterministic fault injection + fault-handling observability
(DESIGN.md §12).

The port's copy of ``repro.faults`` (stdlib and numpy), kept unchanged so
both packages name the same injection points; the registry is the
reference's.

Production GNN serving is judged on what happens when things break (the
full-graph-vs-mini-batch systems comparison, arXiv 2406.00552): a crashed
worker must not hang futures, a corrupt artifact must not be served, a
failed swap must leave the tenant on the stale-but-correct parent plan.
IBMB's precomputed, deterministic batches make principled recovery cheap —
and make the *faults themselves* replayable: every failure path in this
repo is driven through one seeded :class:`FaultInjector` with NAMED
injection points, so a chaos run is a (seed, rates/script) pair, not a
flaky accident.

Injection points (the table in DESIGN.md §12):

==================  ========================================================
point               fires inside
==================  ========================================================
``forward``         ``AsyncGNNEngine._dispatch`` — before each attempt of a
                    window's coalesced forward (transient model failure)
``dispatch_delay``  ``AsyncGNNEngine._dispatch`` — stall before running the
                    window (slow accelerator / noisy neighbor)
``worker_death``    ``AsyncGNNEngine.step`` — after windows are taken off
                    the queue (the dispatcher thread dies mid-flight)
``plan_io``         ``Plan.save`` / ``Plan.load`` (disk write/read error)
``batch_io``        ``repro.ooc.store.PlanStore.read_batch`` — the lazy
                    per-batch disk read behind out-of-core serving/training
                    (DESIGN.md §13). Transient ``OSError`` is retried
                    (bounded); a checksum mismatch is NOT retried — it
                    raises ``PlanFormatError`` like every other corrupt
                    artifact (§12 semantics).
``ckpt_io``         ``Checkpointer`` background save (async write error)
``loader``          ``PrefetchLoader`` worker — staging batch t+1 fails
==================  ========================================================

Two firing modes, combinable per point:

* ``rates={"forward": 0.01}`` — every call draws from a per-point seeded
  ``np.random.Generator``; deterministic for a fixed (seed, call sequence).
* ``script={"forward": [0, 3]}`` — fire on exactly those call indices
  (0-based per point); what the FakeClock test suite uses to place a fault
  on a precise window. When a point has BOTH, they union: scripted indices
  always fire, every other call falls through to the rate draw — how the
  chaos bench guarantees at least one injected fault on top of a
  background rate.

The default everywhere is the :data:`NO_FAULTS` singleton whose
``fire``/``delay`` are constant-returning no-ops — production paths pay one
attribute load + one trivially-inlined call, and no RNG state exists.

Byte corruption (the ``corrupt`` failure class) is not an in-process raise:
tests and benches call :func:`corrupt_file` to deterministically flip bytes
in an artifact on disk, then assert the loader *detects* it
(``PlanFormatError`` / ``CheckpointCorruptError``) instead of serving
garbage.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np


class InjectedFault(RuntimeError):
    """An error raised by a FaultInjector injection point (never by real
    code paths) — test/bench assertions can distinguish injected chaos from
    genuine bugs."""


class WorkerDeath(InjectedFault):
    """Injected crash of a dispatcher/worker loop (the ``worker_death``
    point) — the watchdog-restart failure class."""


#: The canonical registry of injection-point names: point -> where it
#: fires. Every ``fire``/``delay``/``should_fire`` call site, every
#: ``rates=``/``script=`` key in src/ and benchmarks/, and the DESIGN.md
#: §12 table must agree with this dict — enforced both directions by the
#: ``fault-point`` rule of ``repro.analysis`` and by
#: ``tools/check_docs_refs.py`` (DESIGN.md §15). Unit tests may exercise
#: arbitrary point names against a bare ``FaultInjector``; the registry
#: governs the named points production code paths use.
FAULT_POINTS: Dict[str, str] = {
    "forward": "AsyncGNNEngine._dispatch, before each forward attempt",
    "dispatch_delay": "AsyncGNNEngine._dispatch, stall before a window",
    "worker_death": "AsyncGNNEngine.step, after windows go in-flight",
    "plan_io": "Plan.save / Plan.load",
    "ckpt_io": "Checkpointer background save",
    "loader": "PrefetchLoader worker, staging batch t+1",
    "batch_io": "PlanStore.read_batch, before each per-batch disk read",
}


class _NoFaults:
    """Inert injector: the production default. ``fire`` and ``should_fire``
    never trigger, ``delay`` is 0.0, and no RNG/counter state exists, so
    hot paths pay ~zero cost."""

    active = False

    def should_fire(self, point: str) -> bool:
        return False

    def fire(self, point: str, exc=None) -> None:
        return None

    def delay(self, point: str) -> float:
        return 0.0

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {}


NO_FAULTS = _NoFaults()


class FaultInjector:
    """Seeded, named-point fault injector (DESIGN.md §12).

    ``rates`` maps point → per-call firing probability; ``script`` maps
    point → explicit 0-based call indices that fire (when both name a
    point they union: scripted indices always fire, other calls fall
    through to the rate). ``delays`` maps point → seconds returned by
    ``delay`` when that point fires (for stall-style faults). Each point
    gets its own ``np.random.Generator`` derived from (seed, point), so
    adding traffic on one point never perturbs another point's draw
    sequence.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 script: Optional[Dict[str, Sequence[int]]] = None,
                 delays: Optional[Dict[str, float]] = None):
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.script = {k: frozenset(int(i) for i in v)
                       for k, v in (script or {}).items()}
        self.delays = dict(delays or {})
        self._rng: Dict[str, np.random.Generator] = {}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    active = True

    def _gen(self, point: str) -> np.random.Generator:
        g = self._rng.get(point)
        if g is None:
            g = self._rng[point] = np.random.default_rng(
                [self.seed, zlib.crc32(point.encode())])
        return g

    def should_fire(self, point: str) -> bool:
        """Advance this point's call counter; True when this call faults."""
        n = self.calls.get(point, 0)
        self.calls[point] = n + 1
        if point in self.script and n in self.script[point]:
            hit = True
        elif point in self.rates:
            hit = bool(self._gen(point).random() < self.rates[point])
        else:
            hit = False
        if hit:
            self.fired[point] = self.fired.get(point, 0) + 1
        return hit

    def fire(self, point: str, exc=None) -> None:
        """Raise ``exc`` (default :class:`InjectedFault`) when this call of
        ``point`` faults; no-op otherwise."""
        if self.should_fire(point):
            cls = exc or InjectedFault
            raise cls(f"injected fault at {point!r} "
                      f"(call {self.calls[point] - 1}, seed {self.seed})")

    def delay(self, point: str) -> float:
        """Seconds to stall when this call of ``point`` faults, else 0."""
        if point in self.delays and self.should_fire(point):
            return float(self.delays[point])
        return 0.0

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-point {calls, fired} — the chaos bench's evidence that the
        injected failure actually happened."""
        return {p: {"calls": self.calls[p], "fired": self.fired.get(p, 0)}
                for p in sorted(self.calls)}


class FaultStats:
    """Counter bag for fault-handling observability — the ``ServeStats``
    idiom (DESIGN.md §11) applied to the degradation machinery: each layer
    instantiates it with its own counter names, mutates under its own lock,
    and exposes a consistent dict via ``snapshot()`` (DESIGN.md §12)."""

    def __init__(self, *names: str):
        self._names = tuple(names)
        for k in names:
            setattr(self, k, 0)

    def bump(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self._names}


def corrupt_file(path: str, seed: int = 0, nbytes: int = 8,
                 offset: Optional[int] = None) -> List[int]:
    """Deterministically flip ``nbytes`` bytes of ``path`` in place (the
    ``corrupt`` failure class, DESIGN.md §12). With ``offset=None`` the
    positions are drawn seeded from the back half of the file — past the
    zip directory/headers of an ``.npz``, into array payload, where only a
    checksum (ours or the zip member CRC) can catch the damage. Returns the
    corrupted byte offsets so tests can report what they broke."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty — nothing to corrupt")
    rng = np.random.default_rng([seed, zlib.crc32(b"corrupt_file")])
    if offset is not None:
        positions = [int(offset) + i for i in range(nbytes)]
    else:
        lo = size // 2
        positions = sorted(int(p) for p in rng.integers(
            lo, size, size=min(nbytes, max(1, size - lo))))
    with open(path, "r+b") as f:
        for p in positions:
            f.seek(p)
            b = f.read(1)
            f.seek(p)
            f.write(bytes([b[0] ^ 0xFF]))
    return positions

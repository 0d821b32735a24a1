"""Elastic scaling + straggler mitigation over PRECOMPUTED batches.

The port's copy of ``repro.train.elastic`` (pure Python and threads; the
clock is the port's ``serve.common.SystemClock``). Neither package drives
it beyond its tests: the reference's ``launch/train.py`` only names it in
its docstring, and the port's ``launch/train.py`` (its counterpart) does
not call it.

IBMB's determinism is the enabler: the epoch's work is a fixed list of batch
IDs, so distribution questions become pure metadata:

* `partition_batches(ids, num_hosts, host)` — deterministic round-robin lease
  of batch IDs to hosts. On elastic restart with a different host count the
  same call re-partitions — no resharding of data, no sampler state.
* `WorkQueue` — per-epoch work-stealing queue: hosts lease batches; when a
  host finishes its lease it steals from the slowest host's remaining lease.
  Gradient all-reduce stays synchronous; stealing only rebalances the DATA
  path, so a straggling host's disk/NIC can't stall the epoch beyond one
  batch.
* a heartbeat registry with `dead_hosts()` so the coordinator can reassign a
  crashed host's lease at the next epoch boundary (checkpoint/restart covers
  mid-epoch loss of model state).
* `ElasticCoordinator` actually closes that loop (DESIGN.md §12): it folds
  `dead_hosts()` into each epoch's `WorkQueue` via `reassign`, so a crashed
  host's batches are re-leased to survivors and NO batch is silently
  dropped from the epoch.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.serve.common import SystemClock


def partition_batches(batch_ids: Sequence[int], num_hosts: int,
                      host: int) -> List[int]:
    """Deterministic strided lease (stable under elastic host-count change)."""
    return [int(b) for i, b in enumerate(batch_ids) if i % num_hosts == host]


class WorkQueue:
    """In-memory work-stealing queue (single-process stand-in for the
    coordinator service; the API is what a real deployment would back with
    etcd/redis)."""

    def __init__(self, batch_ids: Sequence[int], num_hosts: int):
        self.leases: Dict[int, List[int]] = {
            h: partition_batches(batch_ids, num_hosts, h)
            for h in range(num_hosts)}
        self._lock = threading.Lock()
        self.stolen = 0
        self.reassigned = 0

    def reassign(self, dead: Sequence[int]) -> int:
        """Move every dead host's remaining lease onto the survivors,
        round-robin (DESIGN.md §12). Returns the number of batches moved.
        The dead hosts' lease keys are removed so work-stealing never
        selects them as victims; determinism holds: for a fixed (batch_ids,
        num_hosts, dead set) every host computes the same reassignment."""
        with self._lock:
            gone = [h for h in dead if h in self.leases]
            survivors = sorted(h for h in self.leases if h not in gone)
            if not survivors:
                raise RuntimeError(
                    f"cannot reassign leases: all hosts dead ({list(dead)})")
            moved = 0
            for h in gone:
                for b in self.leases.pop(h):
                    self.leases[survivors[moved % len(survivors)]].append(b)
                    moved += 1
            self.reassigned += moved
            return moved

    def next_batch(self, host: int) -> Optional[int]:
        with self._lock:
            if self.leases[host]:
                return self.leases[host].pop(0)
            # steal from the host with the most remaining work
            victim = max(self.leases, key=lambda h: len(self.leases[h]))
            if self.leases[victim]:
                self.stolen += 1
                return self.leases[victim].pop()   # steal from the tail
            return None

    def remaining(self) -> int:
        with self._lock:
            return sum(len(v) for v in self.leases.values())


class Heartbeats:
    """Host liveness registry. ``clock`` is any object with a monotonic
    ``now()`` (the serving tier's injectable-clock idiom, DESIGN.md §11) so
    timeout behavior is testable with a FakeClock instead of sleeps."""

    def __init__(self, timeout_s: float = 60.0, clock=None):
        self.timeout_s = timeout_s
        # SystemClock.now is monotonic: a wall-clock (time.time) default
        # would declare every host dead across an NTP step backward/DST
        # jump; liveness timeouts must never depend on calendar time
        clock = clock if clock is not None else SystemClock()
        self._now = clock.now
        self._last: Dict[int, float] = {}
        self._lock = threading.Lock()

    def beat(self, host: int) -> None:
        with self._lock:
            self._last[host] = self._now()

    def dead_hosts(self) -> List[int]:
        now = self._now()
        with self._lock:
            return [h for h, t in self._last.items()
                    if now - t > self.timeout_s]


class ElasticCoordinator:
    """Epoch-boundary crash handling (DESIGN.md §12), built on the two
    primitives above: hosts ``beat`` between batches; ``epoch_queue``
    folds ``dead_hosts()`` into the epoch's :class:`WorkQueue` and
    re-leases a crashed host's batches to the survivors via ``reassign``.
    Death is sticky — a host that missed its timeout once stays out until
    ``revive`` (a rejoin is an elastic restart, not a heartbeat)."""

    def __init__(self, num_hosts: int, timeout_s: float = 60.0, clock=None):
        self.num_hosts = int(num_hosts)
        self.heartbeats = Heartbeats(timeout_s, clock=clock)
        self.dead: Set[int] = set()
        self.reassigned_total = 0

    def beat(self, host: int) -> None:
        if host not in self.dead:
            self.heartbeats.beat(host)

    def live_hosts(self) -> List[int]:
        return [h for h in range(self.num_hosts) if h not in self.dead]

    def revive(self, host: int) -> None:
        self.dead.discard(host)
        self.heartbeats.beat(host)

    def epoch_queue(self, batch_ids: Sequence[int]) -> WorkQueue:
        """Build this epoch's work queue with every known-dead host's lease
        already reassigned — the epoch runs over the FULL batch list no
        matter who died last epoch."""
        self.dead.update(self.heartbeats.dead_hosts())
        q = WorkQueue(batch_ids, self.num_hosts)
        if self.dead:
            self.reassigned_total += q.reassign(sorted(self.dead))
        return q

    def snapshot(self) -> Dict:
        return {"num_hosts": self.num_hosts, "dead": sorted(self.dead),
                "reassigned_total": self.reassigned_total}

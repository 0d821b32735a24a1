"""Prefetching host→device loader over the precomputed batch cache.

The port of ``repro.data.loader``. The paper fully pipelines data loading
by prefetching the next batch in parallel (Sec. 5) and observes that ONE
worker suffices because loading is memory-bandwidth-bound: one background
thread stages batch t+1 onto the device while step t computes.

On a CUDA device the worker stages on a side ``torch.cuda.Stream`` of its
own and records an event after the copies; the consumer makes its current
stream wait on that event and calls ``record_stream`` on every staged
tensor, so the caching allocator never hands a staged buffer to another
stream while the step still reads it. Copies are from pageable host memory
(pinned buffers are ROADMAP.md Queue 4 item 8).

Shutdown is sentinel/Event based: a consumer that abandons the iterator
early (break, exception, GC) triggers the generator's ``finally``, which
sets the cancel event; the worker only ever blocks on ``q.put`` with a
timeout and re-checks the event, so it can never be left stranded on a
full queue and the thread always joins.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device, to_tensor
from repro_torch.faults import NO_FAULTS

_STOP = object()

Staged = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


def stage_batch(batch: Mapping[str, np.ndarray], device: torch.device,
                stream: Optional[torch.cuda.Stream] = None) -> Staged:
    """Copy one batch's host arrays to ``device``; on CUDA, on ``stream``,
    returning the event that marks the copies' end (None on the CPU)."""
    if device.type != "cuda":
        return {k: to_tensor(v, device) for k, v in batch.items()}, None
    with torch.cuda.stream(stream):
        out = {k: to_tensor(v, device) for k, v in batch.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def consume(staged: Staged, device: torch.device) -> Dict[str, torch.Tensor]:
    """The staged batch, with ``device``'s current stream ordered after the
    staging copies."""
    batch, done = staged
    if done is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in batch.values():
            t.record_stream(cur)
    return batch


class PrefetchLoader:
    """Iterate device-resident batches in `order`, prefetch depth 1 (paper:
    more workers don't help — memory bandwidth is shared).

    `batches` is anything indexable that yields host-array dicts: a raw
    list, a `BatchCache`, or a `Plan` (DESIGN.md §8) — a Plan is staged
    straight from its contiguous cache and, when no explicit `order` is
    given, iterated in the plan's precomputed schedule order. `device` is
    ``cuda`` unless the caller names another; without a card that raises.
    `group` (super-step staging, DESIGN.md §9) is not ported yet."""

    def __init__(self, batches,
                 order: Optional[np.ndarray] = None,
                 device: DeviceSpec = None,
                 prefetch: int = 1, group: Optional[int] = None,
                 faults=NO_FAULTS):
        if group is not None:
            raise NotImplementedError(
                "super-step staging (group=) is not ported yet (ROADMAP.md, "
                "Queue 1 item 1: Plan.supersteps and data parallel)")
        self.device = resolve_device(device)
        plan_schedule = getattr(batches, "schedule", None)
        cache = getattr(batches, "cache", None)
        if cache is not None:                    # Plan → its contiguous cache
            batches = cache
        if order is None:
            order = np.asarray(plan_schedule) if plan_schedule is not None \
                else np.arange(len(batches))
        order = np.asarray(order)
        # Fail in the caller, not the worker thread: a schedule carried over
        # from a DIFFERENT plan version can reference batches this container
        # no longer holds (refreshed plans may shrink, DESIGN.md §10), and
        # an IndexError raised mid-prefetch surfaces as a cryptic re-raise.
        if len(order) and (int(order.min()) < 0
                           or int(order.max()) >= len(batches)):
            raise IndexError(
                f"order references batch {int(order.max())} but the "
                f"container holds {len(batches)} batches — is this schedule "
                f"from a different (e.g. pre-refresh) plan version?")
        self.batches = batches
        self.order = order
        self.prefetch = max(1, prefetch)
        self.faults = faults            # "loader" injection point (§12)
        self.failed: Optional[BaseException] = None   # last worker error
        self._worker: Optional[threading.Thread] = None  # most recent; tests

    def __len__(self) -> int:
        return len(self.order)

    def _items(self):
        for i in self.order:
            self.faults.fire("loader")
            yield self.batches[int(i)]

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()
        stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

        def put(item) -> bool:
            """Blocking put that aborts when the consumer cancels."""
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._items():
                    if cancel.is_set():
                        return
                    if not put(stage_batch(item, self.device, stream)):
                        return
                put(_STOP)
            except BaseException as e:   # surface in the consumer, never hang
                self.failed = e          # observable even if consumer is gone
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        self._worker = t
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield consume(item, self.device)
        finally:
            # reached on exhaustion AND on early exit (GeneratorExit)
            cancel.set()
            t.join(timeout=10.0)

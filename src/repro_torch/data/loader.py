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

With ``group`` (super-step staging, DESIGN.md §9) the worker stacks
``group`` batches on the host and stages them as one super-step; with a
``DataMesh`` as ``device`` member j lands on mesh entry j, as
``ShardedPlanExecutor.stage`` places it.

Shutdown is sentinel/Event based: a consumer that abandons the iterator
early (break, exception, GC) triggers the generator's ``finally``, which
sets the cancel event; the worker only ever blocks on ``q.put`` with a
timeout and re-checks the event, so it can never be left stranded on a
full queue and the thread always joins.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceSpec, resolve_device, to_tensor
from repro_torch.faults import NO_FAULTS

_STOP = object()

Staged = Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]


def stage_batch(batch: Mapping[str, np.ndarray], device: torch.device,
                stream: Optional[torch.cuda.Stream] = None) -> Staged:
    """Copy one batch's host arrays to ``device``; on CUDA, on ``stream``
    (``device``'s current stream when None), returning the event that
    marks the copies' end (None on the CPU)."""
    if device.type != "cuda":
        return {k: to_tensor(v, device) for k, v in batch.items()}, None
    if stream is None:
        stream = torch.cuda.current_stream(device)
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


def stage_superstep(stacked: Mapping[str, np.ndarray],
                    devices: Sequence[torch.device],
                    streams: Optional[Mapping] = None
                    ) -> List[Tuple[Staged, torch.device]]:
    """Stage one stacked super-step for members on ``devices``: one copy
    per field of the stacked arrays when every member shares one device
    (the members are then views of it), else one copy per member and field
    onto the member's own device. ``streams`` maps a device to its side
    stream (None: the current stream)."""
    streams = streams or {}
    if len(set(devices)) == 1:
        dev = devices[0]
        return [(stage_batch(stacked, dev, streams.get(dev)), dev)]
    return [(stage_batch({k: v[j] for k, v in stacked.items()}, dev,
                         streams.get(dev)), dev)
            for j, dev in enumerate(devices)]


def consume_superstep(parts: Sequence[Tuple[Staged, torch.device]]
                      ) -> Dict:
    """The staged super-step, each field indexable by member: a stacked
    tensor when the members share a device, else a list of tensors."""
    if len(parts) == 1:
        return consume(*parts[0])
    members = [consume(staged, dev) for staged, dev in parts]
    return {k: [m[k] for m in members] for k in members[0]}


class PrefetchLoader:
    """Iterate device-resident batches in `order`, prefetch depth 1 (paper:
    more workers don't help — memory bandwidth is shared).

    `batches` is anything indexable that yields host-array dicts: a raw
    list, a `BatchCache`, or a `Plan` (DESIGN.md §8) — a Plan is staged
    straight from its contiguous cache and, when no explicit `order` is
    given, iterated in the plan's precomputed schedule order. `device` is
    ``cuda`` unless the caller names another; without a card that raises.

    `group` switches to super-step staging (DESIGN.md §9): the loader
    yields `(stacked_batch, weights)` pairs of `group` batches each —
    every field gains a leading axis of length `group`, the ragged tail
    repeats the last real batch with weight 0 (`weights` is a host
    float32 array) — and `device` may be a ``DataMesh``, whose members
    take one batch each (``stage_superstep``), so the stack and staging
    of super-step t+1 overlap with the compute of super-step t."""

    def __init__(self, batches,
                 order: Optional[np.ndarray] = None,
                 device: DeviceSpec = None,
                 prefetch: int = 1, group: Optional[int] = None,
                 faults=NO_FAULTS):
        from repro_torch.dist.data_parallel import DataMesh
        if isinstance(device, DataMesh):
            self.members = device.members
            if group is not None and group != len(self.members):
                raise ValueError(f"group={group} but the mesh has "
                                 f"{len(self.members)} members")
        else:
            self.members = None
            device = resolve_device(device)
        self.device = device
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
        self.group = group if self.members is None else len(self.members)
        self.faults = faults            # "loader" injection point (§12)
        self.failed: Optional[BaseException] = None   # last worker error
        self._worker: Optional[threading.Thread] = None  # most recent; tests

    def __len__(self) -> int:
        if self.group:
            return -(-len(self.order) // self.group)     # super-steps
        return len(self.order)

    def _items(self):
        """What the worker stages: per-batch dicts, or (stacked, weights)
        super-steps when `group` is set."""
        if not self.group:
            for i in self.order:
                self.faults.fire("loader")
                yield self.batches[int(i)]
            return
        from repro_torch.dist.data_parallel import (
            stack_batches, superstep_indices)
        for idx, w in superstep_indices(self.order, self.group):
            self.faults.fire("loader")
            yield stack_batches(self.batches, idx), w

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()
        # the members' devices (one device when not on a mesh), with one
        # side stream per distinct card
        devices = self.members or [self.device]
        streams = {d: torch.cuda.Stream(d) for d in set(devices)
                   if d.type == "cuda"}

        def stage(item):
            if not self.group:
                return stage_batch(item, self.device,
                                   streams.get(self.device))
            stacked, w = item
            return stage_superstep(stacked, devices, streams), w

        def ready(staged):
            if not self.group:
                return consume(staged, self.device)
            staged, w = staged
            return consume_superstep(staged), w

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
                    if not put(stage(item)):
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
                yield ready(item)
        finally:
            # reached on exhaustion AND on early exit (GeneratorExit)
            cancel.set()
            t.join(timeout=10.0)

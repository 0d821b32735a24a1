"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.obs``). Each file under ``metrics/`` whose source is
``program_span`` binds one of these to a metric's name.

A window reader reads the snapshot's records: the program keeps records
only while a profiler collects, and the harness's profiler is on only
inside the measured window (``runner.Window``), so the records hold
exactly the window's spans. A reader returns None where the program has
no ``obs`` module, where its spans are absent, and, for a window reader,
where records were dropped past the program's cap.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def snapshot() -> Optional[Dict]:
    """The program's spans and counters now, or None for a program
    without them."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def _window(snap: Optional[Dict], name: str) -> List[Dict]:
    if not snap or snap["dropped"] > 0:
        return []
    return [r for r in snap["records"] if r["name"] == name]


def _seconds(rows) -> float:
    return sum(r["end_ns"] - r["start_ns"] for r in rows) * 1e-9


def stage_gbps(snap: Optional[Dict], name: str) -> Optional[float]:
    """GB/s of the spans ``name``: their summed ``bytes`` over their summed
    seconds."""
    rows = _window(snap, name)
    secs = _seconds(rows)
    nbytes = sum(r["attrs"].get("bytes", 0) for r in rows)
    return nbytes / secs / 1e9 if secs > 0 and nbytes > 0 else None


def loader_wait_share(snap: Optional[Dict]) -> Optional[float]:
    """Share (%) of the training epochs' seconds the step loop spent
    waiting on the loader's queue."""
    epochs = _seconds(_window(snap, "train.epoch"))
    waits = _window(snap, "loader.wait")
    return 100.0 * _seconds(waits) / epochs if epochs > 0 and waits \
        else None


def schedule_ms(snap: Optional[Dict]) -> Optional[float]:
    """Milliseconds of the batch order (``schedule.order``) per training
    epoch."""
    epochs = _window(snap, "train.epoch")
    orders = _window(snap, "schedule.order")
    return 1e3 * _seconds(orders) / len(epochs) if epochs and orders \
        else None


def step_host_ms(snap: Optional[Dict]) -> Optional[float]:
    """Mean self time (ms) of a training step: ``train.step`` less its
    child ``train.loss_read``, the host's dispatch of one step."""
    steps = _window(snap, "train.step")
    if not steps:
        return None
    reads: Dict[int, int] = {}
    for r in _window(snap, "train.loss_read"):
        reads[r["parent"]] = reads.get(r["parent"], 0) + \
            r["end_ns"] - r["start_ns"]
    own = sum(r["end_ns"] - r["start_ns"] - reads.get(r["id"], 0)
              for r in steps)
    return 1e-6 * own / len(steps)


def plan_cache_s(snap: Optional[Dict]) -> Optional[float]:
    """Seconds the program's plan build spent stacking its batch cache
    (``plan.cache``), from the always-on totals."""
    tot = (snap or {}).get("totals", {}).get("plan.cache")
    return float(tot["seconds"]) if tot else None

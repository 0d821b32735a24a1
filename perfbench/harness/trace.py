"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics read: device busy time, copy time by direction, the
SpMM kernels' time and count, device time by operation, and the idle
gaps by what the host was doing.

The window is the host span ``WINDOW`` that the harness opens around the
measured calls. A device interval counts where it lies inside that span;
busy time is the union of kernel, copy and fill intervals on any stream.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

WINDOW = "perfbench.window"
SPMM = "spmm_bcsr"
HTOD = "Memcpy HtoD"
SHORT_GAP_US = 1000.0


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_us: float
    end_us: float


def from_profile(prof) -> Tuple[List[Span], List[Span], Span]:
    """(device spans, host spans, the window span) of a finished
    ``torch.profiler.profile``, read from its raw Kineto events (building
    the profiler's ``FunctionEvent`` tree takes minutes for a window of
    hundreds of thousands of operations)."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = Span(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
        if e.device_type() == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", lambda: False)():
                device.append(s)
        elif s.name == WINDOW:
            window = s
        else:
            host.append(s)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return device, host, window


def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def summarize(device: Sequence[Span], host: Sequence[Span], window: Span,
              top: int = 10) -> Dict:
    """Seconds of the window, of device activity in it, of host-to-device
    copies, of the SpMM kernels (and their count); the ``top`` device
    operations by time and the ``top`` host activities by the idle device
    time they cover."""
    w0, w1 = window.start_us, window.end_us
    clipped = [Span(s.name, max(s.start_us, w0), min(s.end_us, w1))
               for s in device if s.end_us > w0 and s.start_us < w1]
    busy = _union([(s.start_us, s.end_us) for s in clipped])
    htod = _union([(s.start_us, s.end_us) for s in clipped
                   if s.name.startswith(HTOD)])
    by_name: Dict[str, float] = defaultdict(float)
    spmm_us, spmm_n = 0.0, 0
    for s in clipped:
        by_name[s.name] += s.end_us - s.start_us
        if SPMM in s.name:
            spmm_us += s.end_us - s.start_us
            spmm_n += 1
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    # a gap is named by the shortest host span that covers it (else the
    # one running at its middle); gaps under SHORT_GAP_US are launch
    # overhead between kernels and are summed under one name
    long_gaps = [(a, b) for a, b in gaps if b - a >= SHORT_GAP_US]
    inside = sorted((s for s in host if s.end_us > w0 and s.start_us < w1
                     and s.end_us - s.start_us >= SHORT_GAP_US),
                    key=lambda s: s.end_us - s.start_us)
    idle: Dict[str, float] = defaultdict(float)
    short = _length(gaps) - _length(long_gaps)
    if short > 0:
        idle[f"gaps under {SHORT_GAP_US:g} us"] = short
    for a, b in long_gaps:
        mid = 0.5 * (a + b)
        name = next((s.name for s in inside
                     if s.start_us <= a and s.end_us >= b), None)
        if name is None:
            name = next((s.name for s in inside
                         if s.start_us <= mid <= s.end_us), "host, no span")
        idle[name] += b - a
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": _length(busy) * 1e-6,
        "htod_s": _length(htod) * 1e-6,
        "spmm_s": spmm_us * 1e-6,
        "spmm_calls": spmm_n,
        "device_ops": [[k, v * 1e-6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v * 1e-6] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }

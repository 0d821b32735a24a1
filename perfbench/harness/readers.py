"""The per-layer metrics' arithmetic over a run's context. Each file under
``metrics/`` binds one of these to a metric's name; a reader that finds
nothing to read returns None and the metric is left out of the line.

The context (``runner.py``) holds ``plan_timings`` (the program's
``Plan.timings``) and, in a traced run, ``trace`` (``trace.summarize`` of
the window), ``spmm_bound_s`` and ``spmm_calls`` (the least time and the
number of the SpMM calls the window ran), ``model_flops`` (the model
operations of the window) and ``trace_complete``: whether the trace holds
exactly as many SpMM kernels as the window made calls. A trace that holds
more or fewer has dropped events or caught extra launches; every metric
read from it is then withheld.
"""
from __future__ import annotations

from typing import Dict, Optional

from perfbench.harness.roofline import PEAK_F32_FLOPS


def plan_build_s(ctx: Dict) -> Optional[float]:
    """Seconds the program's plan build took: PPR, preprocessing and the
    plan's cache, schedule and routing (``Plan.timings``)."""
    t = ctx.get("plan_timings")
    return float(sum(t.values())) if t else None


def _busy(ctx):
    tr = ctx.get("trace")
    return tr if tr and ctx.get("trace_complete") and tr["busy_s"] > 0 \
        and tr["window_s"] > 0 else None


def stage_share(ctx: Dict) -> Optional[float]:
    """Share (%) of the device's busy time spent in host-to-device copies."""
    tr = _busy(ctx)
    return None if tr is None else 100.0 * tr["htod_s"] / tr["busy_s"]


def idle_share(ctx: Dict) -> Optional[float]:
    """Share (%) of the traced window with nothing running on the device."""
    tr = _busy(ctx)
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] /
                                            tr["window_s"])


def spmm_roofline(ctx: Dict) -> Optional[float]:
    """The SpMM kernels' least time over their device time (%), both
    summed over every call of the window."""
    tr = _busy(ctx)
    if tr is None or tr["spmm_s"] <= 0:
        return None
    return 100.0 * ctx["spmm_bound_s"] / tr["spmm_s"]


def mfu(ctx: Dict) -> Optional[float]:
    """The window's model operations over the window's seconds at the
    card's float32 peak (%)."""
    tr = _busy(ctx)
    if tr is None or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / (tr["window_s"] * PEAK_F32_FLOPS)


"""What the port's spans cost, and whether their records share the profiler's
clock, on this machine.

    PYTHONPATH=src python3 tools/obs_probe.py [--spans 100000]

Prints one JSON object:

* ``ns_per_span``: a host loop of ``--spans`` empty spans, less the same
  loop without them, with tracing off, on (``obs.enable()``) and under a
  ``torch.profiler`` profile (each span then also enters
  ``record_function``);
* ``clock``: under a profile, how far a main-thread span's record lies from
  the event its ``record_function`` leaves in the trace, and whether a
  ``record_function`` opened in a second thread reaches the trace at all;
* the torch version and, with a card, its name.
"""
import argparse
import json
import sys
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs


def _loop_ns(n: int, with_span: bool) -> float:
    t = time.perf_counter_ns()
    if with_span:
        for _ in range(n):
            with obs.span("probe"):
                pass
    else:
        for _ in range(n):
            pass
    return (time.perf_counter_ns() - t) / n


def per_span_ns(n: int) -> dict:
    """ns a span adds, off, on, and under a profiler (median of 3)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])

    def cost():
        return sorted(_loop_ns(n, True) - _loop_ns(n, False)
                      for _ in range(3))[1]

    obs.reset(cap=4 * n)
    out = {"off": cost()}
    obs.enable()
    out["on"] = cost()
    obs.disable()
    with profile(activities=acts):
        out["profiled"] = cost()
    obs.reset()
    return out


def clock() -> dict:
    obs.reset()

    def worker():
        with record_function("probe.worker_rf"):
            time.sleep(0.002)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        with obs.span("probe.main"):
            time.sleep(0.005)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    rec = next(r for r in obs.records() if r["name"] == "probe.main")
    names = {e.name(): e for e in prof.profiler.kineto_results.events()}
    ev = names.get("probe.main")
    obs.reset()
    return {
        "span_in_trace": ev is not None,
        "start_offset_us": None if ev is None
        else (ev.start_ns() - rec["start_ns"]) * 1e-3,
        "end_offset_us": None if ev is None
        else (ev.end_ns() - rec["end_ns"]) * 1e-3,
        "worker_record_function_in_trace": "probe.worker_rf" in names,
        "unix_minus_perf_counter_s": (time.time_ns()
                                      - time.perf_counter_ns()) * 1e-9,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", type=int, default=100_000)
    args = ap.parse_args(argv)
    out = {"torch": torch.__version__,
           "device": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu",
           "spans": args.spans,
           "ns_per_span": per_span_ns(args.spans),
           "clock": clock()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

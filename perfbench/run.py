"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the result's JSON object; the
last lines of standard error give each number compared beside its limit.
Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result. It measures the PyTorch port (``src/repro_torch``) and
exits 3, with no result, if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def finite(x):
    """``x`` with every non-finite number replaced by 1e300 (worse than
    any reading), so that the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    import repro_torch  # noqa: F401  the program under test
    from perfbench.harness.cell import load_cell
    from perfbench.harness.runner import forbidden_modules, run_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    out = finite(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    print("host " + json.dumps(out["host"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())

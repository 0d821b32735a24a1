"""Run one benchmark cell as ``perfbench/run.py`` does, then print the
program's span records (``repro_torch.obs``) of the run, summed by name.

    python3 tools/run_with_spans.py [--spans-out FILE] --workload <cell> \
        --seed <n> --seconds <s> --trace 1

Standard output is ``run.py``'s; a last line on standard error,
``spans {...}``, gives per span name the count, seconds, summed bytes and
threads of the records, the records dropped, and the window's first and
last record on the Unix clock. ``--spans-out`` writes every record as JSON.
The records exist only in a traced run (``--trace 1``).
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    out_path = None
    if argv[:1] == ["--spans-out"]:
        out_path, argv = argv[1], argv[2:]
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import run
    rc = run.main(argv)
    from repro_torch import obs
    snap = obs.snapshot()
    sums = {}
    for r in snap["records"]:
        s = sums.setdefault(r["name"], {"count": 0, "seconds": 0.0,
                                        "bytes": 0, "threads": []})
        s["count"] += 1
        s["seconds"] += (r["end_ns"] - r["start_ns"]) * 1e-9
        s["bytes"] += r["attrs"].get("bytes", 0)
        if r["thread"] not in s["threads"]:
            s["threads"].append(r["thread"])
    starts = [r["start_ns"] for r in snap["records"]]
    ends = [r["end_ns"] for r in snap["records"]]
    print("spans " + json.dumps({
        "by_name": sums, "dropped": snap["dropped"],
        "first_ns": min(starts, default=None),
        "last_ns": max(ends, default=None)}), file=sys.stderr)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(snap, f)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

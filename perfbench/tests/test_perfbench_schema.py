"""BENCHMARK.json against the benchmark's contract, and the result line
each cell prints, at a tiny size on the CPU."""
import json
import os
import re

import pytest

from _tiny import run_tiny
from perfbench.harness.cell import PERFBENCH, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_meets_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = set(e2e)
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert _line(m["layer"]) and m["name"] not in names
        names.add(m["name"])
        assert os.path.exists(os.path.join(PERFBENCH, "metrics",
                                           f"{m['name']}.py"))
        for w in m.get("workloads", []):
            assert w in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    assert len(set(CELLS)) == len(CELLS)


def _check_line(out, cell_name, traced):
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = load_cell(cell_name)
    want = {m["name"]: m["unit"] for m in
            (cell.per_layer if traced else cell.end_to_end)}
    for name, m in out["metrics"].items():
        assert want[name] == m["unit"] and isinstance(m["value"], float)
    if not traced:
        assert set(out["metrics"]) == set(want)
    else:
        assert "plan_build_s" in out["metrics"]
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, traced):
    out = run_tiny(cell, seconds=1.0, traced=traced)
    _check_line(out, cell, traced)
    assert out["correct"]

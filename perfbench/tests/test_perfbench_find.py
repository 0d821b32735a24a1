"""A cell's configuration, model kind, mix, limits and metric readers are
found by name, as files of their own, from any checkout root."""
import json
import os

import pytest

from perfbench.harness.cell import kind_of, load_cell, load_kind, load_reader


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def test_a_cell_is_found_by_name_from_its_files(tmp_path):
    root = str(tmp_path)
    e2e = [{"name": "rate", "unit": "x/s", "better": "higher",
            "bound": 0.05, "source": "host_clock", "workloads": ["m.mix"]},
           {"name": "setup_s", "unit": "s", "better": "lower",
            "bound": 0.25, "source": "host_clock"},
           {"name": "other", "unit": "s", "better": "lower", "bound": 0.1,
            "source": "host_clock", "workloads": ["n.mix"]}]
    layer = [{"name": "everywhere", "unit": "s", "better": "lower",
              "source": "program_span", "layer": "a", "moves": "setup_s"},
             {"name": "here.only", "unit": "%", "better": "lower",
              "source": "device_trace", "layer": "b", "moves": "rate",
              "workloads": ["m.mix"]},
             {"name": "elsewhere", "unit": "%", "better": "lower",
              "source": "device_trace", "layer": "b", "moves": "other"}]
    _write(os.path.join(root, "BENCHMARK.json"), {
        "command": ["python3", "perfbench/run.py"], "paths": ["perfbench"],
        "run_seconds": 10,
        "configs": [{"name": "m", "source": "https://example.org/m",
                     "file": "perfbench/configs/m.json", "reduced": [],
                     "why": "w"}],
        "workloads": [{"name": "m.mix", "config": "m", "traffic": "mix",
                       "chips": 1, "why": "w"}],
        "end_to_end": e2e, "per_layer": layer})
    pb = os.path.join(root, "perfbench")
    _write(os.path.join(pb, "configs", "m.json"),
           {"model": {"hidden": 7, "kind": "found_kind"}})
    _write(os.path.join(pb, "kinds", "found_kind.py"), "LEAVES = ()\n")
    _write(os.path.join(pb, "mixes", "mix.json"), {"kind": "train"})
    _write(os.path.join(pb, "limits", "m.mix.json"), {"gap": 0.5})
    _write(os.path.join(pb, "metrics", "here.only.py"),
           "def read(ctx):\n    return ctx['x'] * 2\n")
    cell = load_cell("m.mix", root)
    assert cell.config == {"model": {"hidden": 7, "kind": "found_kind"}}
    assert cell.mix == {"kind": "train"} and cell.limits == {"gap": 0.5}
    assert cell.config_name == "m" and cell.traffic == "mix"
    assert [m["name"] for m in cell.end_to_end] == ["rate", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["everywhere", "here.only"]
    assert load_reader("here.only", root)({"x": 21}) == 42


def test_every_metric_of_the_benchmark_has_a_reader():
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert load_reader(m["name"])({}) is None


def test_spmm_roofline_reads_only_a_complete_trace():
    read = load_reader("spmm_roofline.train")
    trace = {"busy_s": 1.0, "window_s": 2.0, "spmm_s": 0.9, "spmm_calls": 90}
    ctx = {"trace": trace, "spmm_calls": 90, "spmm_bound_s": 0.45,
           "trace_complete": True}
    assert abs(read(ctx) - 50.0) < 1e-9
    assert read(dict(ctx, spmm_calls=100, trace_complete=False)) is None


def _tree_with_kind(root, kind, source=None):
    """A checkout holding one cell whose configuration names ``kind``,
    and, with ``source``, ``kinds/<kind>.py``."""
    pb = os.path.join(root, "perfbench")
    _write(os.path.join(root, "BENCHMARK.json"), {
        "configs": [{"name": "m", "file": "perfbench/configs/m.json"}],
        "workloads": [{"name": "m.mix", "config": "m", "traffic": "mix",
                       "chips": 1}],
        "end_to_end": [], "per_layer": []})
    _write(os.path.join(pb, "configs", "m.json"), {"model": {"kind": kind}})
    _write(os.path.join(pb, "mixes", "mix.json"), {"kind": "train"})
    _write(os.path.join(pb, "limits", "m.mix.json"), {})
    if source is not None:
        _write(os.path.join(pb, "kinds", f"{kind}.py"), source)


def test_a_kind_is_found_by_name_from_its_file(tmp_path):
    root = str(tmp_path)
    _tree_with_kind(root, "dropped_kind",
                    "LEAVES = ('w', 'b')\n\n\ndef program_kwargs(model):\n"
                    "    return {'kind': 'gcn'}\n")
    load_cell("m.mix", root)
    kind = kind_of({"kind": "dropped_kind"})
    assert kind.__file__ == os.path.join(root, "perfbench", "kinds",
                                         "dropped_kind.py")
    assert kind.LEAVES == ("w", "b")
    assert kind.program_kwargs({}) == {"kind": "gcn"}
    assert load_kind("dropped_kind", root) is kind


def test_a_missing_kind_fails_by_name(tmp_path):
    root = str(tmp_path)
    _tree_with_kind(root, "no_such_kind")
    with pytest.raises(KeyError, match="no_such_kind"):
        load_cell("m.mix", root)
    with pytest.raises(KeyError, match="no_such_kind"):
        kind_of({"kind": "no_such_kind"})
    with pytest.raises(ValueError, match="not a model kind"):
        load_kind("../configs/m", root)

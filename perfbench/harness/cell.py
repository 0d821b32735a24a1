"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its model kind (``kinds/<kind>.py``), its traffic mix
(``mixes/<traffic>.json``), the limits of its comparison
(``limits/<cell>.json``) and a reader for each per-layer metric
(``metrics/<metric>.py``). A later cell, kind, mix or metric is files of
its own and entries in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import ModuleType
from typing import Callable, Dict, List

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict
    traffic: str
    mix: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]


def _read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    pb = os.path.join(root, "perfbench")
    config = _read_json(os.path.join(root, conf["file"]))
    load_kind(config["model"]["kind"], root)
    return Cell(
        name=name, config_name=w["config"], config=config,
        traffic=w["traffic"],
        mix=_read_json(os.path.join(pb, "mixes", f"{w['traffic']}.json")),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=layer,
        limits=_read_json(os.path.join(pb, "limits", f"{name}.json")))


def load_reader(metric: str, root: str = ROOT) -> Callable[[Dict], object]:
    """``read(ctx)`` of ``perfbench/metrics/<metric>.py``: the metric's
    value from the run's context, or None where it finds nothing."""
    path = os.path.join(root, "perfbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


_KIND_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def load_kind(kind: str, root: str = ROOT) -> ModuleType:
    """The model kind ``kind``: ``perfbench/kinds/<kind>.py`` under
    ``root``, loaded once a process like an import (a later call returns
    the module first loaded under that name, from whichever root). It
    holds everything the harness knows of the kind: see ``kinds/gcn.py``.
    """
    if not isinstance(kind, str) or not _KIND_NAME.fullmatch(kind):
        raise ValueError(f"not a model kind's name: {kind!r}")
    mod_name = "perfbench_kind_" + kind.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(mod_name)
    if mod is not None:
        return mod
    path = os.path.join(root, "perfbench", "kinds", f"{kind}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no model kind {kind!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def kind_of(model: Dict) -> ModuleType:
    """The kind module of a configuration's ``model``."""
    return load_kind(model["kind"])

"""The readers of the tiles staging builds on the card
(``metrics/built_share.*``) on hand-built snapshots: built bytes over all
bytes staged, copied or built, and None where there is nothing to read
(no ``obs``, no staging spans, spans without a ``built_bytes`` count, as
a program that copies every tile has, dropped records)."""
import sys

import pytest

from perfbench.harness import spans
from perfbench.harness.cell import load_reader

STAGES = {"built_share.train": "loader.stage",
          "built_share.infer": "engine.stage"}


def _snap(name, counts, dropped=0):
    return {"records": [{"name": name, "id": i + 1, "parent": None,
                         "thread": "t", "start_ns": 0, "end_ns": 1,
                         "attrs": dict(c)} for i, c in enumerate(counts)],
            "dropped": dropped, "totals": {}}


def _read(monkeypatch, metric, snap):
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return load_reader(metric)({})


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_built_share_is_built_bytes_over_all_staged(monkeypatch, metric):
    snap = _snap(STAGES[metric], [
        dict(bytes=10, pinned_bytes=10, built_bytes=290),
        dict(bytes=100, pinned_bytes=100, built_bytes=0)])
    assert _read(monkeypatch, metric, snap) == pytest.approx(72.5)
    other = "engine.stage" if STAGES[metric] == "loader.stage" \
        else "loader.stage"
    assert _read(monkeypatch, metric, _snap(other, [dict(
        bytes=1, built_bytes=1)])) is None
    nothing = _snap(STAGES[metric], [dict(bytes=5, built_bytes=0)])
    assert _read(monkeypatch, metric, nothing) == 0.0


@pytest.mark.parametrize("metric", sorted(STAGES))
@pytest.mark.parametrize("how", ["no-obs", "empty", "copying-program",
                                 "dropped", "no-bytes"])
def test_built_share_reads_nothing_without_a_count(monkeypatch, metric,
                                                   how):
    name = STAGES[metric]
    snap = {"no-obs": None,
            "empty": _snap(name, []),
            "copying-program": _snap(name, [dict(bytes=5,
                                                 pinned_bytes=5)]),
            "dropped": _snap(name, [dict(bytes=5, built_bytes=5)], 1),
            "no-bytes": _snap(name, [dict(bytes=0, built_bytes=0)])}[how]
    assert _read(monkeypatch, metric, snap) is None


def test_readers_without_obs_in_the_program(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    for metric in STAGES:
        assert load_reader(metric)({}) is None, metric

"""The page-lock readers (``metrics/pinned_share.*``, ``page_lock_s``) on
hand-built snapshots, each returning None where it has nothing to read:
no ``obs``, no staging spans, spans without a ``pinned_bytes`` count (a
program that does not page-lock), dropped records."""
import sys

import pytest

from perfbench.harness import spans
from perfbench.harness.cell import load_reader

STAGES = {"pinned_share.train": "loader.stage",
          "pinned_share.infer": "engine.stage"}


def _snap(name, counts, dropped=0, totals=None):
    return {"records": [{"name": name, "id": i + 1, "parent": None,
                         "thread": "t", "start_ns": 0, "end_ns": 1,
                         "attrs": dict(c)} for i, c in enumerate(counts)],
            "dropped": dropped, "totals": totals or {}}


def _read(monkeypatch, metric, snap):
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return load_reader(metric)({})


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_pinned_share_is_pinned_bytes_over_bytes(monkeypatch, metric):
    snap = _snap(STAGES[metric], [dict(bytes=300, pinned_bytes=300),
                                  dict(bytes=100, pinned_bytes=0)])
    assert _read(monkeypatch, metric, snap) == pytest.approx(75.0)
    other = "engine.stage" if STAGES[metric] == "loader.stage" \
        else "loader.stage"
    assert _read(monkeypatch, metric, _snap(other, [dict(
        bytes=1, pinned_bytes=1)])) is None


@pytest.mark.parametrize("metric", sorted(STAGES))
@pytest.mark.parametrize("how", ["no-obs", "empty", "unpinned-program",
                                 "dropped", "no-bytes"])
def test_pinned_share_reads_nothing_without_a_count(monkeypatch, metric,
                                                    how):
    name = STAGES[metric]
    snap = {"no-obs": None,
            "empty": _snap(name, []),
            "unpinned-program": _snap(name, [dict(bytes=5)]),
            "dropped": _snap(name, [dict(bytes=5, pinned_bytes=5)], 1),
            "no-bytes": _snap(name, [dict(bytes=0, pinned_bytes=0)])}[how]
    assert _read(monkeypatch, metric, snap) is None


def test_page_lock_s_reads_the_total(monkeypatch):
    tot = {"stage.page_lock": {"count": 1, "seconds": 7.25, "bytes": 9}}
    assert _read(monkeypatch, "page_lock_s",
                 _snap("x", [], totals=tot)) == 7.25
    assert _read(monkeypatch, "page_lock_s", _snap("x", [])) is None
    assert _read(monkeypatch, "page_lock_s", None) is None


def test_readers_without_obs_in_the_program(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    for metric in (*STAGES, "page_lock_s"):
        assert load_reader(metric)({}) is None, metric

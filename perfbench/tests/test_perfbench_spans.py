"""The readers of the program's spans (``harness/spans.py``) on hand-built
snapshots, each returning None where it has nothing to read, and a traced
tiny run of each cell whose result line carries them."""
import sys

import pytest

from _tiny import run_tiny
from perfbench.harness import spans
from perfbench.harness.cell import load_cell, load_reader


def _rec(name, rid, parent, start_ms, end_ms, **attrs):
    return {"name": name, "id": rid, "parent": parent, "thread": "t",
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "attrs": attrs}


def _snap(records, dropped=0, totals=None):
    return {"records": records, "dropped": dropped, "totals": totals or {}}


# two epochs of 100 ms; each a 10 ms order, two steps of 20 ms whose loss
# reads take 15 ms, two 5 ms waits, two 2 ms stagings of 1 MB each
TRAIN = [_rec("train.epoch", 1, None, 0, 100, epoch=0, steps=2),
         _rec("train.epoch", 2, None, 100, 200, epoch=1, steps=2)]
for e, base in ((1, 0), (2, 100)):
    TRAIN.append(_rec("schedule.order", 10 * e, e, base, base + 10))
    for k in range(2):
        sid = 10 * e + 1 + 2 * k
        t = base + 10 + 40 * k
        TRAIN += [_rec("loader.wait", 100 + sid, e, t, t + 5),
                  _rec("train.step", sid, e, t + 5, t + 25, step=k),
                  _rec("train.loss_read", sid + 1, sid, t + 10, t + 25),
                  _rec("loader.stage", 200 + sid, e, t, t + 2,
                       bytes=1_000_000)]


def test_readers_on_a_hand_built_snapshot():
    snap = _snap(TRAIN, totals={"plan.cache": {"count": 1, "seconds": 61.5,
                                               "bytes": 7}})
    assert spans.stage_gbps(snap, "loader.stage") == pytest.approx(0.5)
    assert spans.loader_wait_share(snap) == pytest.approx(10.0)
    assert spans.schedule_ms(snap) == pytest.approx(10.0)
    assert spans.step_host_ms(snap) == pytest.approx(5.0)
    assert spans.plan_cache_s(snap) == 61.5
    infer = _snap([_rec("engine.stage", 1, None, 0, 4, bytes=8_000_000)])
    assert spans.stage_gbps(infer, "engine.stage") == pytest.approx(2.0)


@pytest.mark.parametrize("snap", [
    None, _snap([]), _snap(TRAIN, dropped=1),
    _snap([r for r in TRAIN if r["name"] == "train.epoch"])],
    ids=["no-obs", "empty", "dropped", "epochs-only"])
def test_window_readers_return_none_with_nothing_to_read(snap):
    assert spans.stage_gbps(snap, "loader.stage") is None
    assert spans.stage_gbps(snap, "engine.stage") is None
    assert spans.loader_wait_share(snap) is None
    assert spans.schedule_ms(snap) is None
    assert spans.step_host_ms(snap) is None
    assert spans.plan_cache_s(snap) is None


NEW = ("stage_gbps.train", "stage_gbps.infer", "loader_wait_share.train",
       "schedule_ms.train", "step_host_ms.train", "plan_cache_s")


def test_metric_files_read_nothing_from_a_program_without_obs(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert spans.snapshot() is None
    for name in NEW:
        assert load_reader(name)({}) is None, name


@pytest.mark.parametrize("cell, stage", [("gcn-arxiv.train", "loader.stage"),
                                         ("sage-arxiv.infer",
                                          "engine.stage")])
def test_a_traced_run_reports_the_span_metrics(cell, stage):
    from repro_torch import obs
    obs.reset()
    out = run_tiny(cell, seconds=1.0, traced=True)
    want = {m["name"] for m in load_cell(cell).per_layer} & set(NEW)
    assert want <= set(out["metrics"])
    assert "plan_cache_s" in want
    # the window's staged bytes, counted by the program where it copies,
    # are the harness's count of the same
    rows = [r for r in obs.records() if r["name"] == stage]
    assert sum(r["attrs"]["bytes"] for r in rows) == \
        out["host"]["staged_bytes"]
    obs.reset()

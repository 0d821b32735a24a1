"""The port's spans and counters (``repro_torch.obs``): nesting and parents
across threads, totals always on and records only while tracing, the record
cap, the shared clock with the profiler's trace, and the spans of a plan
build, a training fit and an engine run at a tiny size on the CPU."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_dataset
from repro_torch import obs
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.gnn.models import init_gnn
from repro_torch.serve import GNNInferenceEngine, GNNRequest
from repro_torch.train.gnn_trainer import GNNTrainer

PLAN = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32, backend="bcsr", tune_blocks=(16, 32))


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _by_name(rows, names=None):
    """Records by name; with ``names``, only those (another test's
    leftover threads may record spans of their own meanwhile)."""
    out = {}
    for r in rows:
        if names is None or r["name"] in names:
            out.setdefault(r["name"], []).append(r)
    return out



def _here(rows):
    """The records of the calling thread."""
    me = threading.current_thread().name
    return [r for r in rows if r["thread"] == me]


def test_nesting_parents_and_a_worker_thread_s_explicit_parent():
    obs.enable()
    with obs.span("outer", run=7) as outer:
        with obs.span("inner", step=2) as inner:
            inner.add(bytes=10)
            inner.add(bytes=5)
        handed = obs.current()
        done = threading.Event()

        def worker():
            with obs.span("work", parent=handed, batch=3) as w:
                w.add(bytes=4)
                with obs.span("work.child"):
                    pass
            done.set()

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and done.is_set()
    assert obs.current() is None
    rows = _by_name(obs.records())
    (o,), (i,), (w,), (c,) = (rows[n] for n in ("outer", "inner", "work",
                                                 "work.child"))
    assert handed is outer
    assert o["parent"] is None and i["parent"] == o["id"]
    assert w["parent"] == o["id"] and c["parent"] == w["id"]
    assert o["thread"] == threading.current_thread().name
    assert w["thread"] == c["thread"] != o["thread"]
    # identifiers are inherited down the tree; counts stay with their span
    assert i["attrs"] == {"run": 7, "step": 2, "bytes": 15}
    assert w["attrs"] == {"run": 7, "batch": 3, "bytes": 4}
    assert c["attrs"] == {"run": 7, "batch": 3}
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]
    assert o["start_ns"] <= w["start_ns"] <= w["end_ns"] <= o["end_ns"]
    assert inner.seconds == pytest.approx(
        (i["end_ns"] - i["start_ns"]) * 1e-9)
    assert [r["name"] for r in obs.records() if r["name"] in (
        "outer", "inner", "work", "work.child")] == [
        "inner", "work.child", "work", "outer"]


def test_totals_always_on_records_only_while_tracing():
    with obs.span("a") as s:
        s.add(bytes=3)
    with obs.span("a") as s:
        s.add(bytes=4, items=1)
    tot = obs.totals()["a"]
    assert tot["count"] == 2 and tot["bytes"] == 7 and tot["items"] == 1
    assert tot["seconds"] > 0
    assert not [r for r in obs.records() if r["name"] == "a"]
    assert not obs.tracing()

    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.tracing()
        with obs.span("b"):
            pass
    assert not obs.tracing()
    with obs.span("c"):
        pass
    obs.enable()
    with obs.span("d"):
        pass
    obs.disable()
    with obs.span("e"):
        pass
    assert [r["name"] for r in obs.records()
            if r["name"] in "abcde"] == ["b", "d"]
    assert {"a", "b", "c", "d", "e"} <= set(obs.totals())
    snap = obs.snapshot()
    assert snap["totals"]["e"] == obs.totals()["e"]
    assert snap["dropped"] == 0
    with pytest.raises(ValueError):
        obs.span("f").add(seconds=1)


def test_the_record_cap_counts_what_it_drops():
    obs.reset(cap=3)
    obs.enable()
    for _ in range(5):
        with obs.span("x"):
            pass
    assert [r["name"] for r in obs.records()] == ["x"] * 3
    assert obs.dropped() == 2
    assert obs.totals()["x"]["count"] == 5
    obs.reset()
    assert obs.dropped() == 0 and obs.records() == []


def test_records_share_the_profiler_s_clock():
    """A main-thread span's record lies inside the event its
    ``record_function`` leaves in the trace, the nearest within 0.5 ms of
    it (a preempted span only widens its event); a worker thread's span is
    in the records but not in the trace."""

    def worker():
        with obs.span("clock.worker"):
            time.sleep(0.002)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with obs.span("clock.main"):
                time.sleep(0.005)
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    rows = _by_name(obs.records())
    recs, (wrec,) = rows["clock.main"], rows["clock.worker"]
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("clock.main", "clock.worker")),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in events] == ["clock.main"] * 5
    slop = 500_000
    for ev, rec in zip(events, sorted(recs, key=lambda r: r["start_ns"])):
        assert ev.start_ns() - slop <= rec["start_ns"] <= rec["end_ns"] \
            <= ev.end_ns() + slop
    assert min(abs(ev.start_ns() - rec["start_ns"]) for ev, rec in zip(
        events, sorted(recs, key=lambda r: r["start_ns"]))) < slop
    assert wrec["end_ns"] - wrec["start_ns"] >= 2_000_000


@pytest.fixture(scope="module")
def tiny_plans():
    ds = get_dataset("tiny")
    pipe = IBMBPipeline(ds, IBMBConfig(**PLAN))
    return ds, pipe.plan("train"), pipe.plan("test", for_inference=True)


def _model(ds):
    return GNNConfig(in_dim=ds.feat_dim, hidden=32, out_dim=ds.num_classes,
                     num_layers=2, dropout=0.0)


def test_a_fit_s_epochs_steps_and_staged_bytes(tiny_plans):
    ds, train, _test = tiny_plans
    epochs = 2
    obs.enable()
    GNNTrainer(_model(ds), backend="bcsr", device="cpu").fit(
        train, train, ds.num_classes, epochs=epochs, eval_every=epochs + 1)
    rows = _by_name(obs.records())
    steps = len(train.schedule)
    assert len(rows["train.epoch"]) == epochs
    assert [r["attrs"]["steps"] for r in rows["train.epoch"]] == \
        [steps] * epochs
    assert len(rows["train.step"]) == len(rows["train.loss_read"]) == \
        len(rows["loader.stage"]) == steps * epochs
    assert sum(r["attrs"]["bytes"] for r in rows["loader.stage"]) == \
        epochs * train.cache.nbytes()
    epoch_ids = {r["id"]: r["attrs"]["epoch"] for r in rows["train.epoch"]}
    # a step carries (epoch, step), its loss read is its child, and the
    # worker's staging and the consumer's waits hang from the epoch
    for r in rows["train.step"]:
        assert epoch_ids[r["parent"]] == r["attrs"]["epoch"]
    step_ids = {r["id"]: r["attrs"] for r in rows["train.step"]}
    for r in rows["train.loss_read"]:
        assert step_ids[r["parent"]] == r["attrs"]
    for name in ("loader.stage", "loader.wait", "schedule.order"):
        assert {r["parent"] for r in rows[name]} == set(epoch_ids), name
    threads = {r["thread"] for r in rows["loader.stage"]}
    assert threading.current_thread().name not in threads
    for ep in range(epochs):
        assert sorted(r["attrs"]["batch"] for r in rows["loader.stage"]
                      if r["attrs"]["epoch"] == ep) == list(range(steps))


def test_an_engine_run_s_staged_bytes_and_run_id(tiny_plans):
    ds, _train, test = tiny_plans
    cfg = _model(ds)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = GNNInferenceEngine(test, cfg, params, backend="bcsr",
                             cache_batches=0, device="cpu")
    ids = np.asarray(ds.splits["test"])
    reqs = [GNNRequest(ids[i:i + 7]) for i in range(0, len(ids), 7)]
    obs.enable()
    eng.run(reqs)
    rows = _by_name(_here(obs.records()))
    (run,) = rows["engine.run"]
    assert run["attrs"]["requests"] == len(reqs)
    assert run["attrs"]["nodes"] == len(ids)
    staged = rows["engine.stage"]
    assert sorted(r["attrs"]["batch"] for r in staged) == \
        list(range(len(test.cache)))
    assert sum(r["attrs"]["bytes"] for r in staged) == test.cache.nbytes()
    for r in staged:
        assert r["attrs"]["bytes"] == sum(
            v.nbytes for v in test.cache[r["attrs"]["batch"]].values())
    for name in ("engine.stage", "engine.forward", "engine.fetch"):
        assert len(rows[name]) == len(test.cache)
        for r in rows[name]:
            assert r["parent"] == run["id"]
            assert r["attrs"]["run"] == run["attrs"]["run"]


def test_plan_timings_are_the_plan_build_s_spans():
    kw = dict(PLAN)
    obs.enable()
    plan = IBMBPipeline(get_dataset("tiny"), IBMBConfig(**kw)).plan("train")
    rows = _by_name(_here(obs.records()))
    sec = {n: sum((r["end_ns"] - r["start_ns"]) * 1e-9 for r in rs)
           for n, rs in rows.items()}
    assert sorted(plan.timings) == sorted(
        ["ppr/train", "preprocess/train/train", "plan/train/train"])
    assert plan.timings["ppr/train"] == pytest.approx(sec["plan.ppr"],
                                                      abs=1e-9)
    assert plan.timings["preprocess/train/train"] == pytest.approx(
        sec["plan.partition"] + sec["plan.batches"], abs=1e-9)
    assert plan.timings["plan/train/train"] == pytest.approx(
        sec["plan.cache"] + sec["plan.schedule"] + sec["plan.autotune"],
        abs=1e-9)
    (cache,) = rows["plan.cache"]
    assert cache["attrs"]["bytes"] == plan.cache.nbytes()
    # PPR runs inside the partition's span, as it ran inside preprocessing
    (ppr,), (part,) = rows["plan.ppr"], rows["plan.partition"]
    assert ppr["parent"] == part["id"]
    # the spans feed no artifact: the plan is the reference package's
    ref = JaxPipeline(jax_dataset("tiny"), JaxConfig(**kw)).plan("train")
    assert plan.fingerprint == ref.fingerprint
    assert np.array_equal(plan.schedule, ref.schedule)

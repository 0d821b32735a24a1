"""The port's async micro-batching tier (``repro_torch.serve.async_engine``)
against the JAX package's, case by case.

Every case of the reference's ``tests/test_async_engine.py`` and of the
serving half of ``tests/test_faults.py`` (retries, the circuit breaker,
worker death and the watchdog, swap safety, the chaos property) is written
once as a scenario and run on both packages with the same scripted arrival
trace, the same ``FakeClock`` and the same seeded ``FaultInjector``, with
no sleeps. The reference's own assertions hold on each side, and then the
two runs must agree: every future's logits within ATOL = RTOL = 1e-4 (f32
on the CPU, the port's other parity tests' tolerance) or the same error
type and message, and the ``ServeStats`` snapshot (tenants, breaker states
and ``fault_stats`` included) equal. The threaded cases (a real worker
thread on the system clock) run on the port alone, with the reference's
assertions."""
import dataclasses
import threading
import types

import jax
import numpy as np
import pytest

from conftest import FakeClock

ATOL = RTOL = 1e-4
PIPE_KW = dict(variant="node", k_per_output=8, max_outputs_per_batch=32,
               pad_multiple=16)


def _side(name):
    """One package's tier, engine, injector and exception classes, and a
    served tiny test plan with a 2-layer GCN's parameters."""
    if name == "jax":
        from repro import faults, serve
        from repro.core import IBMBConfig, IBMBPipeline
        from repro.core.plan import RoutingIndex
        from repro.core.update import GraphDelta
        from repro.graph.datasets import get_dataset
        from repro.models.gnn import GNNConfig
    else:
        from repro_torch import faults, serve
        from repro_torch.core import IBMBConfig, IBMBPipeline
        from repro_torch.core.plan import RoutingIndex
        from repro_torch.core.update import GraphDelta
        from repro_torch.graph.datasets import get_dataset
        from repro_torch.models.gnn import GNNConfig
    from repro.models.gnn import GNNConfig as JaxGNNConfig
    from repro.models.gnn import init_gnn as jax_init_gnn
    from repro_torch.convert import params_from_jax

    ds = get_dataset("tiny")
    kw = dict(kind="gcn", in_dim=ds.feat_dim, hidden=32,
              out_dim=ds.num_classes, num_layers=2)
    params = jax_init_gnn(JaxGNNConfig(**kw), jax.random.PRNGKey(0))
    if name == "torch":
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 "cpu")
    s = types.SimpleNamespace(name=name, ds=ds, cfg=GNNConfig(**kw),
                              params=params, faults=faults,
                              GraphDelta=GraphDelta,
                              RoutingIndex=RoutingIndex, **{
                                  k: getattr(serve, k) for k in serve.__all__})
    s.FaultInjector, s.WorkerDeath, s.InjectedFault = (
        faults.FaultInjector, faults.WorkerDeath, faults.InjectedFault)

    def pipe():
        return IBMBPipeline(ds, IBMBConfig(**PIPE_KW))

    def engine(cache_batches=4, plan=None):
        extra = {} if name == "jax" else {"device": "cpu"}
        return s.GNNInferenceEngine(plan if plan is not None else s.plan,
                                    s.cfg, s.params,
                                    cache_batches=cache_batches, **extra)

    def tier(clock, tenants=("m",), cache_batches=4, plan=None, faults=None,
             start=False, **cfg_kw):
        cfg_kw.setdefault("window_us", 1000.0)
        return s.AsyncGNNEngine(
            {t: engine(cache_batches, plan) for t in tenants},
            s.AsyncServeConfig(**cfg_kw), clock=clock, start=start,
            faults=faults)

    def fresh_chain():
        p = pipe()
        return p, p.plan("test", for_inference=True)

    s.pipe, s.engine, s.tier, s.fresh_chain = pipe, engine, tier, fresh_chain
    s.plan = pipe().plan("test", for_inference=True)
    assert len(s.plan) >= 2, "window tests need a multi-batch plan"
    return s


@pytest.fixture(scope="module")
def sides():
    return {name: _side(name) for name in ("jax", "torch")}


@pytest.fixture(scope="module")
def port(sides):
    return sides["torch"]


def _batch_nodes(plan, bi):
    return plan.routing.node_ids[np.asarray(plan.routing.batch) == bi]


def _outcome(fut):
    if not fut.done():
        return ("pending",)
    exc = fut.exception(0)
    if exc is not None:
        return ("error", type(exc).__name__, str(exc))
    return ("ok", np.asarray(fut.result(0)))


def _snapshot(tier):
    return tier.snapshot()


def _record(tier, futs, **extra):
    return dict(futs=[_outcome(f) for f in futs], snap=_snapshot(tier),
                faults=tier.fault_stats.snapshot(), **extra)


def _same(a, b, path="record"):
    """Equal records: arrays within ATOL, everything else exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _both(sides, scenario, *args):
    """Run ``scenario(side, *args)`` on both packages; their records must
    agree. Returns the port's record."""
    ref = scenario(sides["jax"], *args)
    got = scenario(sides["torch"], *args)
    _same(got, ref)
    return got


# ------------------------------------------------------------ window policy
def sc_window_full_batch(s):
    tier = s.tier(FakeClock(), window_us=1e9)
    nodes = _batch_nodes(s.plan, 0)
    assert len(nodes) == s.plan.batch_occupancy()[0]
    chunks = np.array_split(nodes, 4)
    futs = [tier.submit("m", c) for c in chunks[:-1]]
    assert tier.step() == 0                      # partial window: hold
    assert not any(f.done() for f in futs)
    futs.append(tier.submit("m", chunks[-1]))    # completes batch 0's rows
    assert tier.step() == len(futs)              # fired on count, t=0
    assert all(f.result(0).shape[0] == len(c) for f, c in zip(futs, chunks))
    assert tier.stats.windows == 1
    assert tier.snapshot()["window_occupancy"] == 1.0
    tier.close()
    return _record(tier, futs)


def sc_window_timeout(s, arrival_trace):
    clock = FakeClock()
    tier = s.tier(clock, window_us=1000.0)
    (fut,) = arrival_trace(tier, clock, [(0.0, "m", s.plan.routing.node_ids[:2])])
    assert not fut.done()
    clock.advance(999e-6)
    assert tier.step() == 0
    clock.advance(1e-6)
    assert tier.step() == 1
    assert fut.done() and fut.latency_s == pytest.approx(1000e-6)
    tier.close()
    return _record(tier, [fut], latency=fut.latency_s)


def sc_coalescing(s):
    nodes = _batch_nodes(s.plan, 0)
    reqs = [nodes[i:i + 2] for i in range(0, 10, 2)]
    out = []
    for kw, runs in ((dict(window_us=1e9), 1),
                     (dict(window_us=0.0, max_requests_per_window=1,
                           occupancy_dispatch=False), len(reqs))):
        tier = s.tier(FakeClock(), cache_batches=0, **kw)
        futs = [tier.submit("m", q) for q in reqs]
        tier.flush()
        assert tier.tenant_engine("m").stats["batch_runs"] == runs
        assert tier.stats.completed == len(reqs)
        tier.close()
        out.append(_record(tier, futs))
    return out


def test_window_fires_on_full_batch_count(sides):
    _both(sides, sc_window_full_batch)


def test_window_fires_on_timeout(sides, arrival_trace):
    _both(sides, sc_window_timeout, arrival_trace)


def test_coalescing_window_shares_one_forward(sides):
    _both(sides, sc_coalescing)


# ------------------------------------------------------- admission control
def sc_deadline_on_arrival(s):
    tier = s.tier(FakeClock(), window_us=0.0, service_time_init_us=10_000.0)
    q = s.plan.routing.node_ids[:2]
    rej = tier.submit("m", q, deadline_ms=5.0)   # estimate: 10ms > 5ms
    assert rej.done() and rej.rejected
    with pytest.raises(s.ServeRejected, match="infeasible"):
        rej.result()
    ok = tier.submit("m", q, deadline_ms=50.0)
    assert not ok.done() and not ok.rejected
    assert (tier.stats.rejected_deadline, tier.stats.accepted) == (1, 1)
    tier.flush()
    assert ok.result().shape == (2, tier.tenant_engine("m").cfg.out_dim)
    tier.close()
    return _record(tier, [rej, ok])


def sc_deadline_expires(s):
    clock = FakeClock()
    tier = s.tier(clock, window_us=1000.0, service_time_init_us=100.0)
    fut = tier.submit("m", s.plan.routing.node_ids[:2], deadline_ms=5.0)
    assert not fut.done()
    runs = tier.tenant_engine("m").stats["batch_runs"]
    clock.advance(0.010)
    assert tier.step() == 1
    with pytest.raises(s.ServeExpired):
        fut.result()
    assert tier.stats.expired == 1
    assert tier.tenant_engine("m").stats["batch_runs"] == runs
    tier.close()
    return _record(tier, [fut])


def sc_queue_full(s):
    tier = s.tier(FakeClock(), window_us=1e9, max_queue=2)
    q = s.plan.routing.node_ids[:1]
    a, b, c = (tier.submit("m", q) for _ in range(3))
    assert c.rejected
    with pytest.raises(s.ServeRejected, match="queue full"):
        c.result()
    assert tier.stats.rejected_full == 1 and tier.stats.queue_depth == 2
    tier.flush()
    d = tier.submit("m", q)
    assert not d.rejected
    tier.close()
    assert d.done()
    return _record(tier, [a, b, c, d])


def sc_unroutable(s):
    tier = s.tier(FakeClock())
    fut = tier.submit("m", [int(s.plan.routing.node_ids.max()) + 10_000])
    assert fut.rejected and tier.stats.rejected_unroutable == 1
    assert tier.stats.queue_depth == 0
    tier.close()
    return _record(tier, [fut])


@pytest.mark.parametrize("scenario", [sc_deadline_on_arrival,
                                      sc_deadline_expires, sc_queue_full,
                                      sc_unroutable],
                         ids=lambda f: f.__name__[3:])
def test_admission_control(sides, scenario):
    _both(sides, scenario)


# ------------------------------------------------------------- correctness
def sc_matches_sync(s):
    sync = s.engine()
    rng = np.random.default_rng(0)
    queries = [rng.choice(s.plan.routing.node_ids, size=5, replace=False)
               for _ in range(8)]
    clock = FakeClock()
    tier = s.tier(clock, window_us=1000.0)
    futs = [tier.submit("m", q) for q in queries]
    clock.advance(1.0)
    tier.step()
    for f, q in zip(futs, queries):              # bitwise, within a package
        assert np.asarray(f.result()).tobytes() == \
            np.asarray(sync.query(q)).tobytes()
    tier.close()
    return _record(tier, futs)


def test_async_results_match_sync_engine(sides):
    _both(sides, sc_matches_sync)


def sc_faulty_tenant(s):
    clock = FakeClock()
    tier = s.tier(clock, tenants=("a", "b"), cache_batches=0)
    eng_a = tier.tenant_engine("a")
    healthy = eng_a._forward

    def exploding_forward(params, batch):
        raise RuntimeError("injected fault: tenant a forward")

    eng_a._forward = exploding_forward
    q = s.plan.routing.node_ids[:3]
    fa = [tier.submit("a", q) for _ in range(2)]
    fb = tier.submit("b", q)
    clock.advance(1.0)
    tier.step()
    for f in fa:
        with pytest.raises(RuntimeError, match="injected fault"):
            f.result()
    assert fb.result().shape == (3, tier.tenant_engine("b").cfg.out_dim)
    assert (tier.stats.window_errors, tier.stats.failed,
            tier.stats.completed) == (1, 2, 1)
    eng_a._forward = healthy
    fut = tier.submit("a", q)
    clock.advance(1.0)
    tier.step()
    assert fut.result() is not None
    tier.close()
    return _record(tier, fa + [fb, fut])


def test_faulty_tenant_fails_only_its_window(sides):
    _both(sides, sc_faulty_tenant)


# ------------------------------------------------------- multi-tenant swap
def _feature_delta(s, plan, rng):
    nodes = rng.choice(plan.routing.node_ids, size=4, replace=False)
    return s.GraphDelta(feat_nodes=nodes.astype(np.int64),
                        feat_values=s.ds.features[nodes] + 0.5)


def sc_swap_mid_stream(s):
    pipe, plan = s.fresh_chain()
    clock = FakeClock()
    tier = s.tier(clock, tenants=("a", "b"), plan=plan)
    warm = plan.routing.node_ids[:4]
    futs = [tier.submit(name, warm) for name in ("a", "b")]
    clock.advance(1.0)
    tier.step()
    eng_a, eng_b = tier.tenant_engine("a"), tier.tenant_engine("b")
    b_lru = set(eng_b._lru)
    assert b_lru
    child, audit = pipe.refresh(plan, _feature_delta(
        s, plan, np.random.default_rng(3)))
    futs += [tier.submit("a", warm), tier.submit("b", warm)]
    assert tier.stats.queue_depth == 2
    res = tier.swap("a", child, audit)
    assert tier.stats.queue_depth == 2           # nothing drained
    assert res["invalidated"] + res["kept"] == len(b_lru)
    clock.advance(1.0)
    tier.step()
    assert all(f.result() is not None for f in futs)
    assert eng_a.plan is child and eng_a.stats["swap_count"] == 1
    assert eng_a.stats["versions"][child.version]["requests"] == 1
    assert eng_b.plan is plan and eng_b.stats["swap_count"] == 0
    assert set(eng_b._lru) == b_lru
    assert tier.snapshot()["tenants"]["a"]["swaps"] == 1
    tier.close()
    return _record(tier, futs, swap=res, audit=eng_a.swap_audit)


def sc_swap_occupancy(s):
    pipe, plan = s.fresh_chain()
    tier = s.tier(FakeClock(), plan=plan, window_us=1e9)
    child, audit = pipe.refresh(plan, _feature_delta(
        s, plan, np.random.default_rng(4)))
    tier.swap("m", child, audit)
    np.testing.assert_array_equal(tier._tenants["m"].occupancy,
                                  child.batch_occupancy())
    fut = tier.submit("m", _batch_nodes(child, 0))
    assert tier.step() == 1
    assert fut.result() is not None
    tier.close()
    return _record(tier, [fut])


def sc_swap_chain(s):
    pipe, plan = s.fresh_chain()
    tier = s.tier(FakeClock(), plan=plan, window_us=0.0)
    rng = np.random.default_rng(5)
    current, futs = plan, []
    for i in range(3):
        for _ in range(4):
            futs.append(tier.submit("m", rng.choice(
                plan.routing.node_ids, size=2, replace=False)))
            tier.step()
        if i < 2:
            child, audit = pipe.refresh(current, _feature_delta(
                s, current, rng))
            tier.swap("m", child, audit)
            current = child
    tier.flush()
    eng = tier.tenant_engine("m").stats
    assert eng["swap_count"] == 2 and sorted(eng["versions"]) == [0, 1, 2]
    assert sum(v["requests"] for v in eng["versions"].values()) == \
        eng["requests"] == 12
    assert tier.snapshot()["completed"] == 12
    tier.close()
    return _record(tier, futs)


@pytest.mark.parametrize("scenario", [sc_swap_mid_stream, sc_swap_occupancy,
                                      sc_swap_chain],
                         ids=lambda f: f.__name__[3:])
def test_swap(sides, scenario):
    _both(sides, scenario)


# --------------------------------------------- stats invariants (property)
def sc_stats_invariants(s, n_requests, cache_batches):
    tier = s.tier(FakeClock(), cache_batches=cache_batches, window_us=0.0,
                  max_requests_per_window=1, occupancy_dispatch=False)
    ids = s.plan.routing.node_ids
    futs = [tier.submit("m", ids[[i % len(ids)]]) for i in range(n_requests)]
    tier.flush()
    snap = tier.snapshot()
    assert snap["submitted"] == snap["accepted"] == snap["completed"] \
        == n_requests
    eng = tier.tenant_engine("m").stats
    assert eng["lru_hits"] + eng["batch_runs"] == n_requests
    if cache_batches == 0:
        assert eng["lru_hits"] == 0
    for k in ("requests", "lru_hits", "batch_runs"):
        assert sum(v[k] for v in eng["versions"].values()) == eng[k], k
    tier.close()
    return _record(tier, futs)


@pytest.mark.parametrize("n_requests, cache_batches",
                         [(1, 0), (7, 1), (20, 4)])
def test_engine_stats_invariants_under_async_drive(sides, n_requests,
                                                   cache_batches):
    _both(sides, sc_stats_invariants, n_requests, cache_batches)


# ================================================= faults: retry + breaker
def sc_retry_absorbs(s):
    clock = FakeClock()
    tier = s.tier(clock, faults=s.FaultInjector(script={"forward": [0]}),
                  max_retries=2)
    fut = tier.submit("m", _batch_nodes(s.plan, 0)[:4])
    clock.advance(2e-3)
    tier.step()
    assert fut.result(0) is not None
    assert tier.fault_stats.retries == 1
    assert tier.stats.window_errors == 0 and tier.stats.completed == 1
    tier.close()
    return _record(tier, [fut])


def sc_retries_exhausted(s):
    clock = FakeClock()
    tier = s.tier(clock, faults=s.FaultInjector(script={"forward": [0, 1]}),
                  max_retries=1)
    fut = tier.submit("m", _batch_nodes(s.plan, 0)[:4])
    clock.advance(2e-3)
    tier.step()
    assert isinstance(fut.exception(0), s.InjectedFault)
    assert tier.fault_stats.retries == 1
    assert tier.stats.window_errors == 1 and tier.stats.failed == 1
    fut2 = tier.submit("m", _batch_nodes(s.plan, 0)[:4])
    clock.advance(2e-3)
    tier.step()
    assert fut2.result(0) is not None
    tier.close()
    return _record(tier, [fut, fut2])


def _fail_windows(tier, clock, plan, n, tenant="m"):
    futs = []
    for _ in range(n):
        futs.append(tier.submit(tenant, _batch_nodes(plan, 0)[:2]))
        clock.advance(2e-3)
        tier.step()
        assert futs[-1].done() and futs[-1].exception(0) is not None
    return futs


def sc_breaker_lifecycle(s):
    clock = FakeClock()
    tier = s.tier(clock, faults=s.FaultInjector(script={"forward": [0, 1]}),
                  breaker_threshold=2, breaker_cooldown_us=50_000.0)
    futs = _fail_windows(tier, clock, s.plan, 2)
    assert tier.snapshot()["tenants"]["m"]["breaker"]["state"] == \
        s.CircuitBreaker.OPEN
    assert tier.fault_stats.breaker_opens == 1
    fut = tier.submit("m", _batch_nodes(s.plan, 0)[:2])
    exc = fut.exception(0)
    assert isinstance(exc, s.ServeUnavailable) and exc.retry_after_ms > 0
    assert tier.stats.rejected_unavailable == 1
    assert tier.fault_stats.fast_rejects == 1 and tier.stats.queue_depth == 0
    clock.advance(0.051)
    probe = tier.submit("m", _batch_nodes(s.plan, 0)[:2])
    assert not probe.done()
    clock.advance(2e-3)
    tier.step()
    assert probe.result(0) is not None
    snap = tier.snapshot()
    assert snap["tenants"]["m"]["breaker"]["state"] == \
        s.CircuitBreaker.CLOSED
    assert tier.fault_stats.breaker_closes == 1
    assert snap["faults"]["injected"]["forward"]["fired"] == 2
    tier.close()
    return _record(tier, futs + [fut, probe],
                   retry_after_ms=exc.retry_after_ms)


def sc_breaker_probe_fails(s):
    clock = FakeClock()
    tier = s.tier(clock,
                  faults=s.FaultInjector(script={"forward": [0, 1, 2]}),
                  breaker_threshold=2, breaker_cooldown_us=50_000.0)
    futs = _fail_windows(tier, clock, s.plan, 2)
    clock.advance(0.051)
    probe = tier.submit("m", _batch_nodes(s.plan, 0)[:2])
    clock.advance(2e-3)
    tier.step()
    assert isinstance(probe.exception(0), s.InjectedFault)
    assert tier.fault_stats.breaker_opens == 2
    fut = tier.submit("m", _batch_nodes(s.plan, 0)[:2])
    assert isinstance(fut.exception(0), s.ServeUnavailable)
    tier.close()
    return _record(tier, futs + [probe, fut])


def sc_breaker_per_tenant(s):
    clock = FakeClock()
    tier = s.tier(clock, tenants=("m", "n"),
                  faults=s.FaultInjector(script={"forward": [0, 1]}),
                  breaker_threshold=2, breaker_cooldown_us=1e9)
    futs = _fail_windows(tier, clock, s.plan, 2)
    shed = tier.submit("m", _batch_nodes(s.plan, 0)[:2])
    assert isinstance(shed.exception(0), s.ServeUnavailable)
    fut = tier.submit("n", _batch_nodes(s.plan, 0)[:2])
    clock.advance(2e-3)
    tier.step()
    assert fut.result(0) is not None
    snap = tier.snapshot()["tenants"]
    assert snap["m"]["breaker"]["state"] == s.CircuitBreaker.OPEN
    assert snap["n"]["breaker"]["state"] == s.CircuitBreaker.CLOSED
    tier.close()
    return _record(tier, futs + [shed, fut])


@pytest.mark.parametrize("scenario", [sc_retry_absorbs, sc_retries_exhausted,
                                      sc_breaker_lifecycle,
                                      sc_breaker_probe_fails,
                                      sc_breaker_per_tenant],
                         ids=lambda f: f.__name__[3:])
def test_retry_and_breaker(sides, scenario):
    _both(sides, scenario)


def test_breaker_unit_threshold_validation(port):
    with pytest.raises(ValueError):
        port.CircuitBreaker(0, 1.0)


# ==================================================== faults: worker death
def sc_worker_death(s):
    clock = FakeClock()
    tier = s.tier(clock,
                  faults=s.FaultInjector(script={"worker_death": [0]}))
    futs = [tier.submit("m", _batch_nodes(s.plan, 0)[i:i + 2])
            for i in (0, 2)]
    clock.advance(2e-3)
    with pytest.raises(s.WorkerDeath):
        tier.step()
    assert all(isinstance(f.exception(0), s.WorkerDeath) for f in futs)
    assert tier.stats.failed == 2 and tier.stats.queue_depth == 0
    fut = tier.submit("m", _batch_nodes(s.plan, 0)[:2])
    clock.advance(2e-3)
    tier.step()
    assert fut.result(0) is not None
    tier.close()
    return _record(tier, futs + [fut])


def sc_fault_storm_close(s):
    tier = s.tier(FakeClock(),
                  faults=s.FaultInjector(rates={"worker_death": 1.0}))
    futs = [tier.submit("m", _batch_nodes(s.plan, 0)[i:i + 2])
            for i in (0, 2)]
    tier.close()
    assert all(f.done() and f.exception(0) is not None for f in futs)
    assert tier.stats.queue_depth == 0
    assert tier.stats.accepted == tier.stats.failed
    return _record(tier, futs)


def sc_dispatch_delay(s):
    """A scripted stall before a window's forward goes through the clock:
    the window's latency grows by exactly the stall."""
    clock = FakeClock()
    tier = s.tier(clock, faults=s.FaultInjector(
        script={"dispatch_delay": [1]}, delays={"dispatch_delay": 0.25}))
    futs = []
    for _ in range(2):
        futs.append(tier.submit("m", _batch_nodes(s.plan, 0)[:2]))
        clock.advance(2e-3)
        tier.step()
    assert futs[0].latency_s == pytest.approx(2e-3)
    assert futs[1].latency_s == pytest.approx(2e-3 + 0.25)
    tier.close()
    return _record(tier, futs, latency=[f.latency_s for f in futs])


@pytest.mark.parametrize("scenario", [sc_worker_death, sc_fault_storm_close,
                                      sc_dispatch_delay],
                         ids=lambda f: f.__name__[3:])
def test_worker_faults(sides, scenario):
    _both(sides, scenario)


# ===================================================== faults: swap safety
def sc_failed_swap_rolls_back(s):
    clock = FakeClock()
    tier = s.tier(clock)
    q = _batch_nodes(s.plan, 0)[:4]
    fut = tier.submit("m", q)
    clock.advance(2e-3)
    tier.step()
    before = np.asarray(fut.result(0))
    bad = dataclasses.replace(s.plan, routing=s.RoutingIndex(
        node_ids=s.plan.routing.node_ids,
        batch=np.full(len(s.plan.routing), 99, np.int32),
        row=s.plan.routing.row))
    with pytest.raises(ValueError, match="out of range"):
        tier.swap("m", bad)
    eng = tier.tenant_engine("m")
    assert eng.plan is s.plan and eng.stats["swap_rollbacks"] == 1
    assert tier.fault_stats.swap_rollbacks == 1
    audit = eng.swap_audit[-1]
    assert audit["ok"] is False and "out of range" in audit["reason"]
    fut2 = tier.submit("m", q)
    clock.advance(2e-3)
    tier.step()
    assert np.asarray(fut2.result(0)).tobytes() == before.tobytes()
    tier.close()
    return _record(tier, [fut, fut2], audit=eng.swap_audit)


def sc_swap_audit_success(s):
    pipe, plan = s.fresh_chain()
    eng = s.engine(plan=plan)
    rng = np.random.default_rng(0)
    touch = plan.routing.node_ids[:2].astype(np.int64)
    delta = s.GraphDelta(feat_nodes=touch, feat_values=rng.normal(
        size=(len(touch), s.ds.feat_dim)).astype(np.float32))
    new_plan, d = pipe.refresh(plan, delta)
    eng.swap(new_plan, d)
    audit = eng.swap_audit[-1]
    assert audit["ok"] is True
    assert (audit["from_version"], audit["to_version"]) == \
        (plan.version, new_plan.version)
    return eng.swap_audit


@pytest.mark.parametrize("scenario", [sc_failed_swap_rolls_back,
                                      sc_swap_audit_success],
                         ids=lambda f: f.__name__[3:])
def test_swap_safety(sides, scenario):
    _both(sides, scenario)


# =============================================== property: futures terminate
def sc_chaos(s, seed):
    clock = FakeClock()
    faults = s.FaultInjector(
        seed=seed, rates={"forward": 0.2, "worker_death": 0.1,
                          "dispatch_delay": 0.2},
        delays={"dispatch_delay": 5e-4})
    tier = s.tier(clock, faults=faults, max_queue=8, max_retries=1,
                  breaker_threshold=3, breaker_cooldown_us=10_000.0)
    rng = np.random.default_rng(seed)
    nodes = s.plan.routing.node_ids
    futs = []
    for i in range(40):
        if rng.random() < 0.1:                   # unroutable id
            q = np.array([10 ** 6 + i])
        else:
            lo = int(rng.integers(0, len(nodes) - 2))
            q = nodes[lo:lo + int(rng.integers(1, 4))]
        futs.append(tier.submit("m", q))
        clock.advance(float(rng.random()) * 2e-3)
        if rng.random() < 0.7:
            try:
                tier.step()
            except s.WorkerDeath:
                pass
    tier.close()
    assert all(f.done() for f in futs)
    st = tier.stats
    assert st.queue_depth == 0
    assert st.submitted == len(futs) == st.accepted + st.rejected
    assert st.accepted == st.completed + st.failed + st.expired
    return _record(tier, futs)


@pytest.mark.parametrize("seed", range(7))
def test_every_submitted_future_terminates_under_chaos(sides, seed):
    rec = _both(sides, sc_chaos, seed)
    assert all(o[0] != "pending" for o in rec["futs"])


# ============================================ threaded (the port alone)
def test_threaded_dispatch_and_clean_shutdown(port):
    tier = port.AsyncGNNEngine({"m": port.engine()},
                               port.AsyncServeConfig(window_us=0.0))
    assert tier._thread.is_alive()
    futs = [tier.submit("m", port.plan.routing.node_ids[i:i + 3])
            for i in range(0, 12, 3)]
    sync = port.engine()
    for f, i in zip(futs, range(0, 12, 3)):
        assert f.result(timeout=60.0).tobytes() == \
            sync.query(port.plan.routing.node_ids[i:i + 3]).tobytes()
    tier.close()
    assert tier._thread is None
    snap = tier.snapshot()
    assert snap["completed"] == len(futs) == snap["accepted"]
    assert snap["queue_depth"] == 0
    with pytest.raises(port.ServeClosed):
        tier.submit("m", port.plan.routing.node_ids[:1])


def test_close_flushes_pending_windows(port):
    tier = port.AsyncGNNEngine({"m": port.engine()},
                               port.AsyncServeConfig(window_us=1e9))
    futs = [tier.submit("m", port.plan.routing.node_ids[:2])
            for _ in range(3)]
    tier.close()
    assert all(f.done() and f.result().shape[0] == 2 for f in futs)
    assert tier.stats.completed == 3


def test_threaded_multi_client_stats_consistent(port):
    tier = port.AsyncGNNEngine({"m": port.engine(cache_batches=2)},
                               port.AsyncServeConfig(window_us=200.0))
    results = []

    def client(seed):
        rng = np.random.default_rng(seed)
        futs = [tier.submit("m", rng.choice(port.plan.routing.node_ids,
                                            size=2, replace=False))
                for _ in range(10)]
        results.append([f.result(timeout=60.0) for f in futs])

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    tier.close()
    assert len(results) == 4 and all(len(r) == 10 for r in results)
    snap = tier.snapshot()
    eng = tier.tenant_engine("m").stats
    assert snap["completed"] == 40 == snap["accepted"] == eng["requests"]
    vs = eng["versions"][0]
    assert vs["requests"] == eng["requests"]
    assert vs["lru_hits"] + vs["batch_runs"] == \
        eng["lru_hits"] + eng["batch_runs"]


def test_threaded_watchdog_restarts_worker(port):
    tier = port.AsyncGNNEngine(
        {"m": port.engine()}, port.AsyncServeConfig(window_us=500.0),
        faults=port.FaultInjector(script={"worker_death": [0]}), start=True)
    f1 = tier.submit("m", _batch_nodes(port.plan, 0)[:2])
    assert isinstance(f1.exception(10.0), port.WorkerDeath)
    f2 = tier.submit("m", _batch_nodes(port.plan, 0)[:2])
    assert f2.result(10.0) is not None
    tier.close()
    assert tier.fault_stats.worker_restarts >= 1
    assert f1.done() and f2.done()


def test_snapshot_waits_for_the_window_in_flight(port, tmp_path):
    """The snapshot race, repaired in the port (the reference keeps it):
    ``snapshot`` reads an out-of-core tenant's engine counters and lazy
    cache under the tenant's lock. Here the window's ``run`` stops in the
    middle of its LRU update — a batch is in the lazy cache, the engine
    has not counted the request yet — until the test releases it. A
    snapshot taken meanwhile must wait, then see the finished window."""
    from repro_torch.ooc import PlanStore, write_store
    write_store(str(tmp_path / "store"), port.plan, chunk_batches=1)
    lazy = PlanStore.open(str(tmp_path / "store")).as_plan(
        resident_batches=1)
    eng = port.engine(plan=lazy)
    entered, release = threading.Event(), threading.Event()
    run = eng.run

    def run_that_stops_mid_update(reqs):
        eng.plan.cache[0]                  # the lazy LRU takes batch 0
        entered.set()
        assert release.wait(60.0)
        return run(reqs)

    eng.run = run_that_stops_mid_update
    tier = port.AsyncGNNEngine({"ooc": eng},
                               port.AsyncServeConfig(window_us=0.0))
    try:
        fut = tier.submit("ooc", _batch_nodes(port.plan, 0)[:2])
        assert entered.wait(60.0)
        snaps = []
        reader = threading.Thread(target=lambda: snaps.append(
            tier.snapshot()))
        reader.start()
        reader.join(timeout=0.5)
        waited = reader.is_alive()
        release.set()
        reader.join(timeout=60.0)
        assert fut.result(60.0).shape[0] == 2
    finally:
        release.set()
        tier.close()
    assert waited, "snapshot read the tenant while its window ran"
    snap = snaps[0]["tenants"]["ooc"]
    assert snap["engine"]["requests"] == 1
    assert snap["engine"]["batch_runs"] == 1
    assert snap["ooc"]["loads"] == 1 and snap["ooc"]["resident"] == 1


def test_ooc_tenant_reports_its_lazy_cache(port, tmp_path):
    """A tenant on an out-of-core plan answers as the resident tenant does,
    bit for bit, and ``snapshot`` carries its lazy cache's counters (None
    for the resident tenant); a scripted ``batch_io`` fault on the store is
    absorbed by a read retry."""
    from repro_torch.ooc import PlanStore, write_store
    write_store(str(tmp_path / "store"), port.plan, chunk_batches=1)
    store = PlanStore.open(str(tmp_path / "store"),
                           faults=port.FaultInjector(script={"batch_io": [1]}))
    lazy = store.as_plan(resident_batches=1)
    clock = FakeClock()
    tier = port.AsyncGNNEngine(
        {"res": port.engine(), "ooc": port.engine(plan=lazy)},
        port.AsyncServeConfig(window_us=1000.0), clock=clock, start=False)
    ids = port.plan.routing.node_ids
    futs = [(t, q, tier.submit(t, q)) for q in (ids[:5], ids[-5:])
            for t in ("res", "ooc")]
    clock.advance(1.0)
    tier.step()
    got = {(t, q.tobytes()): f.result(0) for t, q, f in futs}
    for q in (ids[:5], ids[-5:]):
        assert got[("res", q.tobytes())].tobytes() == \
            got[("ooc", q.tobytes())].tobytes()
    snap = tier.snapshot()["tenants"]
    assert snap["res"]["ooc"] is None
    assert snap["ooc"]["ooc"]["io_io_retries"] == 1
    assert snap["ooc"]["ooc"]["resident"] == 1
    tier.close()

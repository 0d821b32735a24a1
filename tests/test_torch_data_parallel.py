"""The port's data-parallel Plan execution (``repro_torch.dist``) against
the JAX package's, case by case of ``tests/test_data_parallel.py``.

The pure-logic cases (super-step grouping, ``Plan.supersteps``,
``stack_batches`` on every host container, ``mesh_world``,
``superstep_decision``, the loader's ``group=`` staging) must give
array-equal results on both packages. The mesh runs use CPU meshes
(``DataMesh(["cpu"] * w)``, the port's counterpart of the reference's
emulated host devices):

* mesh evaluation and mesh serving are bitwise the port's single-device
  paths, within 1e-4 of JAX's, and the engine's counters equal those of
  the reference's mesh engine (run in a subprocess on 4 emulated devices,
  as the reference's own ``_SUBPROC`` test does).

Tolerance ATOL = RTOL = 1e-4 (f32 on the CPU, sums in other orders). The
mesh ``fit`` cases are in ``tests/test_torch_data_parallel_fit.py``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.data.loader import PrefetchLoader as JaxLoader
from repro.dist import data_parallel as jdp
from repro.faults import FaultInjector as JaxInjector
from repro.faults import InjectedFault as JaxInjectedFault
from repro.graph.sampling import make_batcher as jax_make_batcher
from repro.graph.datasets import get_dataset as jax_get_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.gnn import policy as jax_policy
from repro.train import GNNTrainer as JaxTrainer
from repro_torch.convert import params_from_jax
from repro_torch.core import IBMBConfig, IBMBPipeline
from repro_torch.data.loader import PrefetchLoader
from repro_torch.device import stage
from repro_torch.dist import data_parallel as tdp
from repro_torch.dist.data_parallel import (
    DataMesh, ShardedPlanExecutor, mesh_world, replicate)
from repro_torch.faults import FaultInjector, InjectedFault
from repro_torch.graph.datasets import get_dataset
from repro_torch.graph.sampling import make_batcher
from repro_torch.models.gnn import GNNConfig
from repro_torch.models.gnn import policy as port_policy
from repro_torch.optim import tree_leaves
from repro_torch.optim.accumulate import GradAccumulator
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.serve import GNNInferenceEngine, GNNRequest
from repro_torch.train import GNNTrainer

ATOL = RTOL = 1e-4
# the reference's _pipe settings (tests/test_data_parallel.py:32-38)
PIPE = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
            pad_multiple=32)
# plan-build pins that force every batch's auto decision to bcsr with
# block_f 0 (the reference's _bcsr_pins)
BCSR_PINS = dict(backend="bcsr", autotune=True, auto_kappa=1e9,
                 tune_block_fs=())
# the bcsr plans' tile sizes, two candidates (as tests/test_torch_train.py)
BCSR = dict(backend="bcsr", tune_blocks=(16, 32))


def _plans(jds, ds, **kw):
    """Each package's train, val and test plans of the tiny dataset."""
    cfg = dict(PIPE, **kw)
    jp, tp = JaxPipeline(jds, JaxConfig(**cfg)), IBMBPipeline(
        ds, IBMBConfig(**cfg))
    return dict(
        jax=(jp.plan("train"), jp.plan("val", for_inference=True),
             jp.plan("test", for_inference=True)),
        port=(tp.plan("train"), tp.plan("val", for_inference=True),
              tp.plan("test", for_inference=True)))


@pytest.fixture(scope="module")
def env():
    jds, ds = jax_get_dataset("tiny"), get_dataset("tiny")
    e = dict(jds=jds, ds=ds, segment=_plans(jds, ds),
             bcsr=_plans(jds, ds, **BCSR),
             kw=dict(kind="gcn", in_dim=ds.feat_dim, hidden=32,
                     out_dim=ds.num_classes, num_layers=2))
    assert len(e["segment"]["port"][0]) % 4 != 0, "want a ragged tail"
    return e


def _cfg(env, dropout=0.3, **kw):
    return GNNConfig(**env["kw"], dropout=dropout, **kw)


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


# ------------------------------------------------------------ super-steps
@pytest.mark.parametrize("order,world", [
    ([3, 1, 2, 0], 2),                       # exact fit
    ([5, 4, 3, 2, 1], 4),                    # ragged tail
    ([2, 0, 1], 1),                          # world one is the identity
    ([6, 2, 4, 0, 1, 3, 5], 3)])
def test_superstep_indices_equal_the_reference(order, world):
    got = tdp.superstep_indices(np.array(order), world)
    want = jdp.superstep_indices(np.array(order), world)
    assert len(got) == len(want) == -(-len(order) // world)
    for (gi, gw), (wi, ww) in zip(got, want):
        assert gi.dtype == wi.dtype and gw.dtype == ww.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
    flat = np.concatenate([i[w > 0] for i, w in got])
    assert flat.tolist() == list(order)


def test_superstep_indices_reject_world_zero():
    with pytest.raises(ValueError, match="world"):
        tdp.superstep_indices(np.arange(3), 0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_plan_supersteps_equal_the_reference(env, world):
    jplan, tplan = env["segment"]["jax"][0], env["segment"]["port"][0]
    got, want = tplan.supersteps(world), jplan.supersteps(world)
    assert len(got) == len(want) == -(-len(tplan) // world)
    for (gi, gw), (wi, ww) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
    flat = np.concatenate([i[w > 0] for i, w in got])
    np.testing.assert_array_equal(flat, tplan.schedule)


def _hosts(plan, tmp_path, pkg):
    """The three host containers of one plan: its BatchCache, a list of
    batch dicts and an out-of-core LazyBatchCache."""
    if pkg == "jax":
        from repro.ooc import PlanStore, write_store
    else:
        from repro_torch.ooc import PlanStore, write_store
    path = str(tmp_path / f"store-{pkg}")
    write_store(path, plan, chunk_batches=2)
    lazy = PlanStore.open(path).as_plan(resident_batches=2).cache
    return {"cache": plan.cache,
            "list": [plan.cache[i] for i in range(len(plan))],
            "lazy": lazy}


@pytest.mark.parametrize("host", ["cache", "list", "lazy"])
def test_stack_batches_equal_the_reference(env, tmp_path, host):
    jplan, tplan = env["bcsr"]["jax"][0], env["bcsr"]["port"][0]
    idx = np.array([1, 0, 1, 3])
    got = tdp.stack_batches(_hosts(tplan, tmp_path, "port")[host], idx)
    want = jdp.stack_batches(_hosts(jplan, tmp_path, "jax")[host], idx)
    assert sorted(got) == sorted(want) == sorted(tplan.cache.fields)
    for k in got:
        assert got[k].shape[0] == len(idx)
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k][1], tplan.cache[0][k])


def test_lazy_stack_goes_through_the_verified_read(env, tmp_path):
    lazy = _hosts(env["segment"]["port"][0], tmp_path, "port")["lazy"]
    tdp.stack_batches(lazy, np.array([0, 1, 2]))
    assert lazy.stats["loads"] == 3 and lazy.stats["evictions"] == 1


# ------------------------------------------------------- meshes / plumbing
def test_mesh_world_and_members():
    with pytest.raises(ValueError, match="data axis"):
        mesh_world(DataMesh(["cpu"], ("model",)))
    with pytest.raises(ValueError, match="data axis"):
        DataMesh(["cpu"], ("model",)).members
    assert mesh_world(DataMesh(["cpu"])) == 1
    pod = DataMesh([["cpu"] * 2] * 2, ("pod", "data"))
    assert mesh_world(pod) == 4 and pod.shape == {"pod": 2, "data": 2}
    assert pod.members == [torch.device("cpu")] * 4
    # a non-data axis contributes its first entry only
    dm = DataMesh([["cpu", "meta"]] * 3, ("data", "model"))
    assert mesh_world(dm) == 3 and dm.members == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="axis names"):
        DataMesh(["cpu", "cpu"], ("pod", "data"))


def test_data_mesh_takes_the_visible_cards_and_needs_one():
    if torch.cuda.is_available():
        mesh = tdp.data_mesh()
        assert mesh.members == [torch.device("cuda", i) for i in
                                range(torch.cuda.device_count())]
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tdp.data_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        DataMesh(["cuda"])


def test_replicate_clones_every_leaf_per_member():
    tree = {"w": torch.ones(4, 3), "b": torch.zeros(3)}
    reps = replicate(tree, DataMesh(["cpu"] * 3))
    assert len(reps) == 3
    ptrs = {tree["w"].data_ptr()}
    for rep in reps:
        assert torch.equal(rep["w"], tree["w"]) and \
            torch.equal(rep["b"], tree["b"])
        assert rep["w"].data_ptr() not in ptrs
        ptrs.add(rep["w"].data_ptr())


@pytest.mark.parametrize("decisions,idx", [
    ([("bcsr", 32)] * 4, [0, 1, 2, 3]),                   # uniform
    ([("bcsr", 32), ("bcsr", 64), ("bcsr", 32)], [0, 1, 2]),  # mixed bf
    ([("bcsr", 0), ("segment", 0), ("dense", 0)], [0, 1, 2]),
    ([("dense", 0), ("bcsr", 0)], [0, 0])])                # a padded group
def test_superstep_decision_equals_the_reference(decisions, idx):
    got = port_policy.superstep_decision(decisions, np.array(idx))
    assert got == jax_policy.superstep_decision(decisions, np.array(idx))


def test_train_superstep_refreshes_every_replica(env):
    """After a super-step every replica holds the new master parameters,
    and the update is the mean of the members' gradients (Adam from a
    fresh state, dropout 0) — checked against one manual update."""
    tr = env["segment"]["port"][0]
    cfg = _cfg(env, dropout=0.0)
    mesh = DataMesh(["cpu"] * 3)
    opt = get_optimizer("adam")
    ex = ShardedPlanExecutor(mesh, cfg, opt)
    params = GNNTrainer(cfg, device="cpu").init_params()
    idx, w = ex.supersteps(tr.schedule)[0]
    trainer = GNNTrainer(cfg, device="cpu")
    grad = trainer._steps_for("segment")["grad"]
    gs = [grad(params, stage(tr.cache[int(i)], "cpu"), None)[1] for i in idx]
    acc = GradAccumulator(len(gs))
    mean = [acc.add(g) for g in gs][-1]
    want, _ = trainer._steps_for("segment")["apply"](
        params, opt.init(params), mean, 1e-3)

    reps = ex.replicate(params)
    batch, wd = ex.stage(tr.cache, idx, w)
    gens = [None] * ex.world
    got, _, losses = ex.train_superstep(params, reps, opt.init(params),
                                        batch, wd, 1e-3, gens)
    assert len(losses) == 3
    assert _same_params(got, want)
    for rep in reps:
        assert _same_params(rep, got)


# ------------------------------------------------------- fit: the errors
def test_fit_mesh_raises_the_reference_s_errors(env):
    tr, va, _ = env["segment"]["port"]
    jtr, jva, _ = env["segment"]["jax"]
    mesh, jmesh = DataMesh(["cpu"]), jdp.data_mesh(1)
    cases = [
        (dict(grad_accum=2), tr, "grad_accum"),
        (dict(nonfinite_policy="skip"), tr, "nonfinite_policy"),
        ({}, make_batcher("neighbor_sampling", env["ds"], num_batches=2),
         "fixed batches")]
    jbt = jax_make_batcher("neighbor_sampling", env["jds"], num_batches=2)
    assert not jbt.fixed
    for (kw, train, match), jtrain in zip(cases, [jtr, jtr, jbt]):
        with pytest.raises(ValueError, match=match) as got:
            GNNTrainer(_cfg(env), device="cpu", **kw).fit(
                train, va, env["ds"].num_classes, epochs=1, mesh=mesh)
        with pytest.raises(ValueError, match=match) as want:
            JaxTrainer(JaxGNNConfig(**env["kw"], dropout=0.3), **kw).fit(
                jtrain, jva, env["ds"].num_classes, epochs=1, mesh=jmesh)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------- evaluation
def _jax_init(env):
    return jax.tree_util.tree_map(np.asarray, jax_init_gnn(
        JaxGNNConfig(**env["kw"], dropout=0.0),
        jax.random.fold_in(jax.random.PRNGKey(0), 0)))


@pytest.mark.parametrize("plans,world", [("segment", 4), ("bcsr", 2)])
def test_mesh_evaluate_is_single_device_bitwise(env, plans, world):
    _, va, _ = env[plans]["port"]
    _, jva, _ = env[plans]["jax"]
    jparams = _jax_init(env)
    cfg = _cfg(env, dropout=0.0, backend=plans)
    params = params_from_jax(jparams, "cpu")
    ex = ShardedPlanExecutor(DataMesh(["cpu"] * world), cfg)
    got = ex.evaluate(ex.replicate(params), va.cache)
    assert got == GNNTrainer(cfg, device="cpu").evaluate(params, va)
    want = JaxTrainer(JaxGNNConfig(**env["kw"], dropout=0.0,
                                   backend=plans)).evaluate(jparams, jva)
    _close(got["loss"], want["loss"])
    _close(got["acc"], want["acc"])


# ---------------------------------------------------------------- serving
_SUBPROC = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import sys; sys.path.insert(0, "src")
import json
import jax, numpy as np
from repro.core import IBMBPipeline, IBMBConfig
from repro.graph.datasets import get_dataset
from repro.models.gnn import GNNConfig, init_gnn
from repro.serve import GNNInferenceEngine, GNNRequest
from repro.dist.data_parallel import data_mesh

SCENARIO = json.loads(sys.argv[1])
ds = get_dataset("tiny")
plan = IBMBPipeline(ds, IBMBConfig(**SCENARIO["pipe"])).plan(
    "test", for_inference=True)
cfg = GNNConfig(**SCENARIO["kw"], dropout=0.0)
params = init_gnn(cfg, jax.random.PRNGKey(0))
out = {}
for world in SCENARIO["worlds"]:
    em = GNNInferenceEngine(plan, cfg, params, mesh=data_mesh(world),
                            cache_batches=SCENARIO["cache_batches"])
    got = [em.query(np.asarray(q)).tolist() for q in SCENARIO["queries"]]
    reqs = [GNNRequest(node_ids=np.asarray(q)) for q in SCENARIO["run"]]
    em.run(reqs)
    got += [r.logits.tolist() for r in reqs]
    out[world] = {"logits": got, "stats": {k: em.stats[k] for k in (
        "requests", "nodes", "batch_runs", "lru_hits", "supersteps",
        "evictions")}}
print(json.dumps({"devices": jax.device_count(), "out": out}))
"""
WORLDS = (2, 3, 4)


def _serve_scenario(env):
    """Queries touching every test batch, two batches, and one again,
    then a coalesced run(): cold misses, a padded super-step, a lone miss
    and LRU hits at each world."""
    plan = env["segment"]["port"][2]
    rb, ids = np.asarray(plan.routing.batch), plan.routing.node_ids
    test = env["ds"].splits["test"]
    two = np.concatenate([ids[rb == 1][:3], ids[rb == 2][:2]])
    return dict(pipe=PIPE, kw=env["kw"], worlds=list(WORLDS),
                cache_batches=2,
                queries=[test.tolist(), two.tolist(), test[:4].tolist(),
                         two.tolist()],
                run=[test.tolist(), test[:3].tolist(),
                     ids[rb == 3][:2].tolist()])


@pytest.fixture(scope="module")
def jax_mesh_engine(env):
    """The reference's mesh engine on 4 emulated devices."""
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROC, json.dumps(_serve_scenario(env))],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["devices"] == 4
    return res["out"]


def _port_answers(engine, scenario):
    got = [engine.query(np.asarray(q)) for q in scenario["queries"]]
    reqs = [GNNRequest(node_ids=np.asarray(q)) for q in scenario["run"]]
    engine.run(reqs)
    assert all(r.done for r in reqs)
    np.testing.assert_array_equal(reqs[1].logits, reqs[0].logits[:3])
    return got + [r.logits for r in reqs]


@pytest.mark.parametrize("world", WORLDS)
def test_engine_mesh_routing_parity(env, jax_mesh_engine, world):
    scenario = _serve_scenario(env)
    plan = env["segment"]["port"][2]
    cfg = _cfg(env, dropout=0.0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_init_gnn(
        JaxGNNConfig(**env["kw"], dropout=0.0), jax.random.PRNGKey(0))),
        "cpu")
    em = GNNInferenceEngine(plan, cfg, params, cache_batches=2,
                            mesh=DataMesh(["cpu"] * world))
    e1 = GNNInferenceEngine(plan, cfg, params, cache_batches=2,
                            device="cpu")
    got, single = _port_answers(em, scenario), _port_answers(e1, scenario)
    ref = jax_mesh_engine[str(world)]
    for g, s, r in zip(got, single, ref["logits"]):
        assert g.tobytes() == s.tobytes()
        _close(g, np.asarray(r, np.float32))
    assert {k: em.stats[k] for k in ref["stats"]} == ref["stats"]
    assert em.stats["supersteps"] > 0 and e1.stats["supersteps"] == 0


def test_engine_mesh_counts_match_the_reference_s_formulas(env):
    """The reference's own assertions (test_engine_mesh_routing_parity):
    every batch runs once, in ceil(batches / world) super-steps, and
    repeat traffic is served from the LRU."""
    plan = env["segment"]["port"][2]
    test = env["ds"].splits["test"]
    cfg = _cfg(env, dropout=0.0)
    params = GNNTrainer(cfg, device="cpu").init_params()
    world = 4
    em = GNNInferenceEngine(plan, cfg, params, cache_batches=len(plan),
                            mesh=DataMesh(["cpu"] * world))
    em.query(test)
    assert em.stats["batch_runs"] == len(plan)
    assert em.stats["supersteps"] == -(-len(plan) // world)
    em.query(test)
    assert em.stats["batch_runs"] == len(plan) and em.stats["lru_hits"] > 0


def test_swap_and_params_re_replicate(env):
    """The replicas are copies: a new parameter set assigned to the
    engine, an in-place change of the master followed by a swap, and a
    refused swap (rollback) all leave every replica equal to the master,
    and the answers equal a fresh single-device engine's."""
    plan = env["segment"]["port"][2]
    test = env["ds"].splits["test"]
    cfg = _cfg(env, dropout=0.0)
    p1 = GNNTrainer(cfg, device="cpu").init_params(1)
    p2 = GNNTrainer(cfg, device="cpu").init_params(2)
    em = GNNInferenceEngine(plan, cfg, p1, cache_batches=len(plan),
                            mesh=DataMesh(["cpu"] * 2))

    def replicas_hold_master():
        return len(em._replicas) == 2 and all(
            _same_params(r, em.params) for r in em._replicas)

    def fresh(params):
        return GNNInferenceEngine(plan, cfg, params, device="cpu").query(test)

    assert replicas_hold_master()
    em.query(test)
    em.params = p2
    em.swap(plan)                                  # drops the LRU
    assert replicas_hold_master()
    assert em.query(test).tobytes() == fresh(p2).tobytes()
    assert em.stats["supersteps"] == 4

    for t in tree_leaves(em.params):               # the master, in place
        t.mul_(0.5)
    assert not replicas_hold_master()
    em.swap(plan)
    assert replicas_hold_master()
    assert em.query(test).tobytes() == fresh(em.params).tobytes()

    for t in tree_leaves(em.params):
        t.add_(0.25)
    bad = env["segment"]["port"][0]                # not a test-split plan
    with pytest.raises(ValueError, match="delta parents"):
        em.swap(bad, delta=type("D", (), dict(
            parent_fingerprint="x", child_fingerprint="y"))())
    assert em.stats["swap_rollbacks"] == 1 and em.plan is plan
    assert replicas_hold_master()


def test_engine_mesh_runs_on_the_first_member(env):
    plan = env["segment"]["port"][2]
    cfg = _cfg(env, dropout=0.0)
    params = GNNTrainer(cfg, device="cpu").init_params()
    em = GNNInferenceEngine(plan, cfg, params, mesh=DataMesh(["cpu"] * 2))
    assert em.device == torch.device("cpu")
    assert all(t.device == em.device for t in tree_leaves(em.params))
    with pytest.raises(ValueError, match="not both"):
        GNNInferenceEngine(plan, cfg, params, mesh=DataMesh(["cpu"] * 2),
                           device="cpu")


# ----------------------------------------------------------- loader group
@pytest.mark.parametrize("host", ["plan", "cache", "lazy"])
def test_loader_group_staging_equals_the_reference(env, tmp_path, host):
    jplan, tplan = env["bcsr"]["jax"][0], env["bcsr"]["port"][0]
    world = 4
    jhost = {"plan": jplan, "cache": jplan.cache,
             "lazy": _hosts(jplan, tmp_path, "jax")["lazy"]}[host]
    thost = {"plan": tplan, "cache": tplan.cache,
             "lazy": _hosts(tplan, tmp_path, "port")["lazy"]}[host]
    order = np.asarray(tplan.schedule)
    jinj, tinj = JaxInjector(), FaultInjector()
    want = list(JaxLoader(jhost, order, group=world, faults=jinj))
    loader = PrefetchLoader(thost, order, group=world, device="cpu",
                            faults=tinj)
    got = list(loader)
    assert len(got) == len(loader) == len(want) == -(-len(tplan) // world)
    assert tinj.calls["loader"] == jinj.calls["loader"] == len(got)
    for (gb, gw), (wb, ww) in zip(got, want):
        np.testing.assert_array_equal(gw, np.asarray(ww))
        assert sorted(gb) == sorted(wb)
        for k in gb:
            assert gb[k].shape[0] == world
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))
    assert sum(int((w > 0).sum()) for _, w in got) == len(tplan)


def test_loader_on_a_mesh_places_members_as_stage_does(env):
    tplan = env["segment"]["port"][0]
    mesh = DataMesh(["cpu"] * 4)
    ex = ShardedPlanExecutor(mesh, _cfg(env))
    got = list(PrefetchLoader(tplan, device=mesh))
    steps = ex.supersteps(tplan.schedule)
    assert len(got) == len(steps)
    for (batch, w), (idx, wi) in zip(got, steps):
        want, _ = ex.stage(tplan.cache, idx, wi)
        np.testing.assert_array_equal(w, wi)
        for k in want:
            assert torch.equal(batch[k], want[k])
            assert torch.equal(tdp.member(batch, 2)[k],
                               torch.as_tensor(tplan.cache[int(idx[2])][k]))


def test_loader_fault_fires_once_per_superstep(env):
    """A scripted ``loader`` fault on super-step 1 surfaces in the
    consumer after super-step 0, on both packages."""
    tplan, jplan = env["segment"]["port"][0], env["segment"]["jax"][0]
    for loader_cls, plan, inj, exc, kw in (
            (PrefetchLoader, tplan, FaultInjector(script={"loader": [1]}),
             InjectedFault, {"device": "cpu"}),
            (JaxLoader, jplan, JaxInjector(script={"loader": [1]}),
             JaxInjectedFault, {})):
        seen = []
        with pytest.raises(exc):
            for batch, w in loader_cls(plan, group=4, faults=inj, **kw):
                seen.append(w)
        assert len(seen) == 1 and inj.calls["loader"] == 2

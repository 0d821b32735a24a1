"""The port's dynamic-graph path against the JAX package's: ``GraphDelta``,
``IBMBPipeline.refresh`` and ``GNNInferenceEngine.swap``.

The refresh is host numpy on both sides, so refreshed plans and their
``PlanDelta`` audit records must be bitwise equal to the reference's, for
every case of the reference's own refresh tests (``tests/test_update.py``):
feature-only, structural, output-set and batch-variant deltas. Logits go
through the GCN in f32 on the CPU; the port's refreshed plan is held to a
from-scratch plan within ATOL = RTOL = 1e-4, the tolerance of the port's
other parity tests (the two plans give the same batches, so the logits
agree to the last bit in practice)."""
import copy
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import GraphDelta as JaxDelta
from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_get_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.serve import GNNInferenceEngine as JaxEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    GraphDelta, IBMBConfig, IBMBPipeline, Plan, PlanDelta, check_routing)
from repro_torch.graph.datasets import get_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.serve import GNNInferenceEngine
from repro_torch.train import GNNTrainer

ATOL = RTOL = 1e-4
PIPE_KW = dict(variant="node", k_per_output=8, max_outputs_per_batch=16,
               pad_multiple=32)


def _pipes(**kw):
    cfg = dict(PIPE_KW, **kw)
    return (JaxPipeline(jax_get_dataset("tiny"), JaxConfig(**cfg)),
            IBMBPipeline(get_dataset("tiny"), IBMBConfig(**cfg)))


def _mixed(ds):
    """Features + edge insert/delete + label flip around a few test outputs
    (the reference's ``_mixed_delta``), as plain keyword arrays."""
    test = ds.splits["test"]
    u, v = int(test[0]), int(test[1])
    nb = ds.graph.neighbors(u)
    feat_nodes = np.asarray(test[:3], dtype=np.int64)
    return dict(
        feat_nodes=feat_nodes, feat_values=ds.features[feat_nodes] + 0.5,
        edge_inserts=None if np.isin(v, nb) else np.array([[u, v]]),
        edge_deletes=np.array([[u, int(nb[0])]]) if len(nb) else None,
        label_nodes=np.array([u]),
        label_values=np.array([(int(ds.labels[u]) + 1) % ds.num_classes]))


def _feature_only(ds, plan):
    nid = plan.node_ids[0]
    target = int(nid[nid >= 0][0])
    return dict(feat_nodes=np.array([target]),
                feat_values=ds.features[[target]] + 1.0)


def _output_set(ds, plan):
    test = ds.splits["test"]
    val_only = np.setdiff1d(ds.splits["val"],
                            np.concatenate([test, ds.splits["train"]]))
    return dict(output_adds={"test": val_only[:2]},
                output_removes={"test": test[:2]})


def _edge_delete(ds, plan):
    u = int(ds.splits["test"][0])
    return dict(edge_deletes=np.array([[u, int(ds.graph.neighbors(u)[0])]]))


def _assert_same_plan(ref, port):
    assert port.fingerprint == ref.fingerprint
    assert sorted(port.cache.fields) == sorted(ref.cache.fields)
    for k, v in ref.cache.fields.items():
        got = port.cache.fields[k]
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k
    assert port.cache.meta == ref.cache.meta
    for f in ("node_ids", "batch", "row"):
        assert np.array_equal(getattr(port.routing, f),
                              getattr(ref.routing, f)), f
    assert np.array_equal(port.schedule, ref.schedule)
    assert np.array_equal(port.node_ids, ref.node_ids)
    assert np.array_equal(port.batch_backend, ref.batch_backend)
    assert np.array_equal(port.batch_block_f, ref.batch_block_f)
    assert port.meta == ref.meta
    assert (port.version, port.parent) == (ref.version, ref.parent)
    if ref.ppr is None:
        assert port.ppr is None
    else:
        for f in ("roots", "indices", "values"):
            assert np.array_equal(getattr(port.ppr, f),
                                  getattr(ref.ppr, f)), f


def _assert_same_audit(ref, port):
    for f in ("parent_fingerprint", "child_fingerprint", "version",
              "dirty_roots", "fallback"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("rebuilt", "patched", "untouched", "dirty"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    assert port.summary() == ref.summary()


# ------------------------------------------------------------- GraphDelta

def test_delta_apply_is_copy_on_write_and_the_reference_s():
    jds, ds = jax_get_dataset("tiny"), get_dataset("tiny")
    kw = _mixed(ds)
    before = (ds.features.copy(), ds.labels.copy(), ds.graph.num_edges)
    ds2 = GraphDelta(**kw).apply(ds)
    assert np.array_equal(ds.features, before[0])      # untouched
    assert np.array_equal(ds.labels, before[1])
    assert ds.graph.num_edges == before[2]
    assert not np.array_equal(ds2.features, ds.features)
    ref = JaxDelta(**kw).apply(jds)
    for g in ("graph", "norm_graph"):
        for f in ("indptr", "indices", "weights"):
            a, b = getattr(getattr(ds2, g), f), getattr(getattr(ref, g), f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (g, f)
    assert ds2.features.tobytes() == ref.features.tobytes()
    assert ds2.labels.tobytes() == ref.labels.tobytes()
    for split in ("train", "val", "test"):
        assert np.array_equal(ds2.splits[split], ref.splits[split])
    assert GraphDelta(**kw).summary() == JaxDelta(**kw).summary()
    assert GraphDelta(**kw).is_structural
    assert np.array_equal(GraphDelta(**kw).touched_nodes(),
                          JaxDelta(**kw).touched_nodes())


def test_delta_validation():
    ds = get_dataset("tiny")
    with pytest.raises(ValueError, match="come together"):
        GraphDelta(feat_nodes=np.array([0]))
    with pytest.raises(ValueError, match="pairs"):
        GraphDelta(edge_inserts=np.array([0, 1]))
    with pytest.raises(ValueError, match="self-loop"):
        GraphDelta(edge_inserts=np.array([[3, 3]])).apply(ds)
    with pytest.raises(ValueError, match="shape"):
        GraphDelta(feat_nodes=np.array([0]),
                   feat_values=np.zeros((1, 3))).apply(ds)
    with pytest.raises(ValueError, match="duplicate"):
        GraphDelta(feat_nodes=np.array([5, 5]),
                   feat_values=np.zeros((2, ds.feat_dim)))
    with pytest.raises(ValueError, match="duplicate"):
        GraphDelta(label_nodes=np.array([5, 5]),
                   label_values=np.array([0, 1]))
    with pytest.raises(ValueError, match="range"):
        GraphDelta(feat_nodes=np.array([-1]),
                   feat_values=np.zeros((1, ds.feat_dim))).apply(ds)
    with pytest.raises(ValueError, match="range"):
        GraphDelta(label_nodes=np.array([ds.num_nodes]),
                   label_values=np.array([0])).apply(ds)
    test = ds.splits["test"]
    with pytest.raises(ValueError, match="already in the split"):
        GraphDelta(output_adds={"test": test[:1]}).apply(ds)
    train_only = np.setdiff1d(ds.splits["train"], test)
    with pytest.raises(ValueError, match="not.*in the split"):
        GraphDelta(output_removes={"test": train_only[:1]}).apply(ds)


# ----------------------------------------------------------- the refresh

REFRESH_CASES = {
    # name: (pipeline kwargs, delta maker, split/mode)
    "feature-only": (dict(), _feature_only, ("test", True)),
    "structural": (dict(), lambda ds, plan: _mixed(ds), ("test", True)),
    "structural-bcsr": (dict(backend="bcsr", tune_blocks=(16, 32)),
                        lambda ds, plan: _mixed(ds), ("test", True)),
    "structural-train": (dict(backend="bcsr"),
                         lambda ds, plan: _mixed(ds), ("train", False)),
    "output-set": (dict(), _output_set, ("test", True)),
    "batch-variant": (dict(variant="batch", num_batches=3), _edge_delete,
                      ("test", True)),
}


@pytest.mark.parametrize("name", sorted(REFRESH_CASES))
def test_refresh_is_bitwise_the_reference_s(name):
    pkw, make, (split, inference) = REFRESH_CASES[name]
    jpipe, pipe = _pipes(**pkw)
    jplan = jpipe.plan(split, for_inference=inference)
    plan = pipe.plan(split, for_inference=inference)
    _assert_same_plan(jplan, plan)
    kw = make(pipe.ds, plan)
    jchild, jaudit = jpipe.refresh(jplan, JaxDelta(**kw))
    child, audit = pipe.refresh(plan, GraphDelta(**kw))
    assert isinstance(audit, PlanDelta)
    _assert_same_plan(jchild, child)
    _assert_same_audit(jaudit, audit)
    check_routing(child)
    assert child.version == 1 and child.parent == plan.fingerprint
    # the pipeline advanced: its fingerprint is the child's
    assert pipe.fingerprint(split, inference) == child.fingerprint
    if name == "feature-only":
        assert len(audit.rebuilt) == 0 and audit.dirty_roots == 0
        assert len(audit.patched) >= 1 and audit.fallback is None
    if name in ("structural", "structural-bcsr"):
        assert len(audit.rebuilt) >= 1 and audit.fallback is None
    if name == "structural-train":         # a batch outgrows its caps
        assert audit.fallback.startswith("caps exceeded")
    if name == "batch-variant":
        assert audit.fallback is not None and len(audit.untouched) == 0


def test_refresh_chain_roundtrips_and_loaded_plans_refresh():
    """version/parent advance along the chain, survive save/load, and a
    loaded plan refreshes from its stored top-k, bitwise as the
    reference's chain does."""
    import tempfile
    jpipe, pipe = _pipes()
    ds = pipe.ds
    plan = pipe.plan("test", for_inference=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/v0.npz"
        plan.save(path)
        cold = IBMBPipeline(copy.copy(ds), IBMBConfig(**PIPE_KW))
        loaded = cold.load_plan(path, "test", for_inference=True)
        child, audit = cold.refresh(loaded, GraphDelta(**_mixed(ds)))
        assert audit.fallback is None
        kw2 = dict(feat_nodes=np.array([0]), feat_values=ds.features[[0]] - 1)
        grand, _ = cold.refresh(child, GraphDelta(**kw2))
        grand.save(f"{tmp}/v2.npz")
        back = Plan.load(f"{tmp}/v2.npz")
        assert (back.version, back.parent) == (2, child.fingerprint)
        assert cold.load_plan(f"{tmp}/v2.npz", "test",
                              for_inference=True).version == 2
    jplan = jpipe.plan("test", for_inference=True)
    jchild, _ = jpipe.refresh(jplan, JaxDelta(**_mixed(ds)))
    jgrand, _ = jpipe.refresh(jchild, JaxDelta(**kw2))
    _assert_same_plan(jgrand, grand)


def test_refresh_rejects_foreign_and_stale_plans():
    _jpipe, pipe = _pipes()
    plan = pipe.plan("test", for_inference=True)
    other = IBMBPipeline(get_dataset("tiny"), IBMBConfig(
        **dict(PIPE_KW, k_per_output=4))).plan("test", for_inference=True)
    with pytest.raises(ValueError, match="fingerprint"):
        pipe.refresh(other, GraphDelta())
    delta = GraphDelta(**_mixed(pipe.ds))
    pipe.refresh(plan, delta)
    with pytest.raises(ValueError, match="fingerprint"):
        pipe.refresh(plan, delta)


def _gcn(ds, backend):
    kw = dict(kind="gcn", in_dim=ds.feat_dim, hidden=32,
              out_dim=ds.num_classes, num_layers=2, dropout=0.0)
    params = jax.tree_util.tree_map(np.asarray, jax_init_gnn(
        JaxGNNConfig(**kw), jax.random.PRNGKey(0)))
    return kw, params


@pytest.mark.parametrize("backend", ["segment", "bcsr"])
def test_refreshed_logits_match_scratch(backend):
    """A refreshed plan answers like a from-scratch plan on the post-delta
    graph, through the port's engine and trainer."""
    _jpipe, pipe = _pipes(backend="bcsr")
    ds = pipe.ds
    plan = pipe.plan("test", for_inference=True)
    delta = GraphDelta(**_mixed(ds))
    child, _audit = pipe.refresh(plan, delta)
    ds2 = delta.apply(ds)
    scratch = IBMBPipeline(ds2, IBMBConfig(**dict(PIPE_KW, backend="bcsr"))) \
        .plan("test", for_inference=True)
    assert scratch.fingerprint == child.fingerprint
    kw, params = _gcn(ds, backend)
    cfg, tp = GNNConfig(**kw), params_from_jax(params, "cpu")
    query = np.asarray(ds2.splits["test"])
    got = GNNInferenceEngine(child, cfg, tp, backend=backend,
                             device="cpu").query(query)
    want = GNNInferenceEngine(scratch, cfg, tp, backend=backend,
                              device="cpu").query(query)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    trainer = GNNTrainer(cfg, backend=backend, device="cpu")
    ev_child, ev_scratch = (trainer.evaluate(tp, p) for p in (child, scratch))
    assert ev_child["acc"] == pytest.approx(ev_scratch["acc"], abs=1e-6)
    assert ev_child["loss"] == pytest.approx(ev_scratch["loss"], abs=ATOL)


# -------------------------------------------------------- engine hot swap

def _private_nodes_of_batch0(plan):
    others = set()
    for i in range(1, plan.num_batches):
        m = plan.node_ids[i]
        others |= set(m[m >= 0].tolist())
    m0 = plan.node_ids[0]
    return sorted(set(m0[m0 >= 0].tolist()) - others)


def test_swap_matches_the_reference_engine():
    """The same traffic, refresh and swaps through both engines: the same
    keep/invalidate counts, stats (per version too), swap_audit and
    refusals with rollback; the served logits agree within ATOL."""
    jpipe, pipe = _pipes()
    ds = pipe.ds
    jplan, plan = (p.plan("test", for_inference=True) for p in (jpipe, pipe))
    assert plan.num_batches > 2
    kw, params = _gcn(ds, "segment")
    n = plan.num_batches
    je = JaxEngine(jplan, JaxGNNConfig(**kw), params, cache_batches=n)
    te = GNNInferenceEngine(plan, GNNConfig(**kw),
                            params_from_jax(params, "cpu"), cache_batches=n,
                            device="cpu")
    test = ds.splits["test"]
    for e in (je, te):
        e.query(test)                          # fill the LRU completely
    only0 = _private_nodes_of_batch0(plan)
    assert only0
    kw1 = dict(feat_nodes=np.asarray(only0),
               feat_values=ds.features[only0] + 1.0)
    jchild, jaudit = jpipe.refresh(jplan, JaxDelta(**kw1))
    child, audit = pipe.refresh(plan, GraphDelta(**kw1))
    assert list(audit.dirty) == [0]
    swapped = te.swap(child, audit)
    assert swapped == je.swap(jchild, jaudit) == \
        {"invalidated": 1, "kept": n - 1}
    np.testing.assert_allclose(te.query(test), je.query(test), atol=ATOL,
                               rtol=RTOL)
    assert te.stats["batch_runs"] == n + 1     # only the dirty batch re-ran

    # refusals: the wrong parent, an audit of another plan, a plan without
    # the tiles a bcsr engine needs; each rolls back and is audited
    kw2 = dict(feat_nodes=np.asarray(only0[:1]),
               feat_values=ds.features[only0[:1]] - 2.0)
    jgrand, jaudit2 = jpipe.refresh(jchild, JaxDelta(**kw2))
    grand, audit2 = pipe.refresh(child, GraphDelta(**kw2))
    for (eng, bad_plan, bad_audit, match) in (
            (je, jplan, jaudit, None), (te, plan, audit, "chain|parents"),
            (je, jchild, jaudit2, None), (te, child, audit2,
                                          "audit|describe")):
        with pytest.raises(ValueError, match=match):
            eng.swap(bad_plan, bad_audit)
    assert te.plan is child and te.stats["swap_rollbacks"] == 2
    for e in (je, te):                         # still serving the child
        before = e.query(test)
        np.testing.assert_array_equal(e.query(test), before)
    te.swap(grand, audit2)
    je.swap(jgrand, jaudit2)
    for e in (je, te):
        e.query(test[::-1])
        e.swap(e.plan, None)                   # no audit: drop the whole LRU
    keys = ("requests", "nodes", "batch_runs", "lru_hits", "evictions",
            "swap_count", "swap_rollbacks")
    assert {k: te.stats[k] for k in keys} == {k: je.stats[k] for k in keys}
    assert te.stats["versions"] == je.stats["versions"]
    assert sorted(te.stats["versions"]) == [0, 1, 2]
    assert len(te.swap_audit) == len(je.swap_audit) == 5
    for a, b in zip(te.swap_audit, je.swap_audit):
        assert a.keys() == b.keys() and a["ok"] == b["ok"]
        assert {k: v for k, v in a.items() if k != "reason"} == \
            {k: v for k, v in b.items() if k != "reason"}


def _damaged_routing(plan):
    """``plan`` with its first routing entry pointed at another node's row:
    ``check_routing`` refuses it."""
    row = np.array(plan.routing.row)
    row[0] = (row[0] + 1) % plan.cache.fields["output_idx"].shape[1]
    return dataclasses.replace(
        plan, routing=dataclasses.replace(plan.routing, row=row))


def test_swap_refuses_a_plan_without_tiles_and_damaged_routing():
    _jpipe, pipe = _pipes(backend="bcsr")
    bcsr_plan = pipe.plan("test", for_inference=True)
    seg_plan = IBMBPipeline(get_dataset("tiny"), IBMBConfig(**PIPE_KW)) \
        .plan("test", for_inference=True)
    kw, params = _gcn(pipe.ds, "bcsr")
    eng = GNNInferenceEngine(bcsr_plan, GNNConfig(**kw),
                             params_from_jax(params, "cpu"), backend="bcsr",
                             cache_batches=bcsr_plan.num_batches,
                             device="cpu")
    ids = bcsr_plan.routing.node_ids
    want = eng.query(ids)
    with pytest.raises(ValueError, match="bcsr"):
        eng.swap(seg_plan)
    damaged = _damaged_routing(bcsr_plan)
    with pytest.raises(ValueError, match="routing"):
        eng.swap(damaged)
    assert eng.plan is bcsr_plan
    assert eng.stats["swap_count"] == 0 and eng.stats["swap_rollbacks"] == 2
    assert [a["ok"] for a in eng.swap_audit] == [False, False]
    runs = eng.stats["batch_runs"]
    np.testing.assert_array_equal(eng.query(ids), want)
    assert eng.stats["batch_runs"] == runs     # still served from the LRU

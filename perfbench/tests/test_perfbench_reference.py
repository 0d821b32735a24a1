"""The reference against the port at a tiny size: its graph, batches and
epoch order are the port's; every cell's run is correct, and so is a cell
of a kind added as files alone; a run whose timed path is broken
underneath comes out not correct."""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import repro_torch.serve.gnn_engine as ge
import repro_torch.train.gnn_trainer as gt
from _tiny import run_tiny, tiny, tiny_cell
from perfbench.harness import data, plan_ref, reference, runner
from perfbench.harness.cell import PERFBENCH, load_cell


@pytest.fixture(scope="module")
def graph():
    return data.load_graph(tiny_cell("gcn-arxiv.train").config["dataset"])


def test_graph_is_the_port_s_generator(graph):
    from repro_torch.graph.csr import gcn_preprocess
    from repro_torch.graph.synthetic import SyntheticSpec, make_sbm_dataset
    spec = dict(tiny_cell("gcn-arxiv.train").config["dataset"])
    spec.pop("generator")
    g, feats, labels, splits = make_sbm_dataset(SyntheticSpec(name="t",
                                                              **spec))
    norm = gcn_preprocess(g)
    for a, b in ((graph.indptr, g.indptr), (graph.indices, g.indices),
                 (graph.n_indptr, norm.indptr),
                 (graph.n_indices, norm.indices),
                 (graph.n_weights, norm.weights), (graph.features, feats),
                 (graph.labels, labels)):
        np.testing.assert_array_equal(a, b)
    for k in splits:
        np.testing.assert_array_equal(graph.splits[k], splits[k])


@pytest.mark.parametrize("split,infer", [("train", False), ("test", True)])
def test_batches_and_orders_are_the_port_s(graph, split, infer):
    from repro_torch.core.pipeline import IBMBConfig, IBMBPipeline
    from repro_torch.core.scheduling import make_schedule
    ibmb = tiny_cell("gcn-arxiv.train").config["ibmb"]
    ds = runner.as_dataset("t", graph)
    batches = IBMBPipeline(ds, IBMBConfig(**ibmb)).preprocess(split, infer)
    ref = plan_ref.reference_batches(graph, ibmb, split, infer)
    assert len(ref) == len(batches) > 2
    for rb, b in zip(ref, batches):
        ids = b.node_ids[b.node_ids >= 0]
        np.testing.assert_array_equal(plan_ref.local_order(graph, rb), ids)
        np.testing.assert_array_equal(
            rb.outputs, np.sort(ids[b.output_idx[b.output_mask]]))
    labels = [graph.labels[rb.outputs] for rb in ref]
    for seed in (0, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            plan_ref.tsp_order(labels, graph.num_classes, seed),
            make_schedule(labels, graph.num_classes, "tsp", seed=seed))


def test_trainer_init_is_the_port_s():
    from repro_torch.train.gnn_trainer import GNNTrainer
    cell = tiny_cell("gcn-arxiv.train")
    for kind in ("gcn", "sage"):
        model = dict(cell.config["model"], kind=kind)
        t = GNNTrainer(runner.gnn_config(model), seed=77, device="cpu")
        got = reference.flatten(t.init_params())
        want = reference.trainer_init(model, 77, torch.device("cpu"))
        assert list(got) == list(want) == reference.leaf_names(model)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


CELLS = ["gcn-arxiv.train", "sage-arxiv.infer"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_correct_at_a_tiny_size(cell):
    out = run_tiny(cell, seconds=1.0)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"] / 3 or c["limit"] == 0, name


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(gt, "apply_updates", lambda params, updates: params)


def _half_batch(monkeypatch):
    inner = gt.masked_xent

    def half(logits, labels, mask):
        keep = torch.arange(mask.shape[0]) % 2 == 0
        return inner(logits, labels, mask * keep.to(mask.dtype))

    monkeypatch.setattr(gt, "masked_xent", half)


def _answer_altered(monkeypatch):
    """One answer of every ``run`` (its first request's first logit)
    altered as the engine produces it."""
    inner = ge.GNNInferenceEngine.run

    def run(self, requests):
        out = inner(self, requests)
        done = [r for r in requests if r.done and r.logits is not None
                and len(r.logits)]
        if done:
            done[0].logits = done[0].logits.copy()
            done[0].logits[0, 0] += 0.5
        return out

    monkeypatch.setattr(ge.GNNInferenceEngine, "run", run)


@pytest.mark.parametrize("cell,fault", [
    ("gcn-arxiv.train", _unchanged_state),
    ("gcn-arxiv.train", _half_batch),
    ("sage-arxiv.infer", _answer_altered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_tiny(cell, seconds=1.0)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_the_tf32_control_fails_on_the_card():
    """The reference in TF32 put in the program's place fails the limits
    of the training and the inference cells, on the card (TF32 exists
    there only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is a tensor-core precision")
    from perfbench.harness import check
    dev = torch.device("cuda")
    cell = tiny_cell("gcn-arxiv.train")
    cell.config["model"]["hidden"] = 256
    g = data.load_graph(cell.config["dataset"])
    seed = 2 ** 31 + 99
    ref = runner.train_reference(cell, g, seed, dev)
    ctl = runner.train_reference(cell, g, seed, dev, tf32=True)
    nums = check.train_numbers(dict(losses=ctl["losses"], p0=ctl["init"],
                                    grad1=ctl["grad1"],
                                    p_after=ctl["p_after"]),
                               ref, ref["init"])
    assert not check.verdict(dict(nums, plan_wrong=0.0), cell.limits), nums
    inf = tiny_cell("sage-arxiv.infer")
    inf.config["model"]["hidden"] = 256
    params = runner.make_params(inf.config["model"], seed, dev)
    rb = plan_ref.reference_batches(g, inf.config["ibmb"], "test", True)[0]
    flat = reference.flatten(params)
    want = reference.batch_logits(inf.config["model"], g, flat, rb.nodes,
                                  rb.outputs, dev)
    got = reference.batch_logits(inf.config["model"], g, flat, rb.nodes,
                                 rb.outputs, dev, tf32=True)
    assert check.logit_gap(got, want) > inf.limits["logit_gap"]


def test_a_kind_joins_by_its_files_alone(tmp_path):
    """A kind written as files into a checkout of its own (GCN's module
    under another name, so it runs the program's ``gcn``), with its
    configuration, mix, limits and cell, runs ``correct`` through the
    harness as it stands."""
    pb = tmp_path / "perfbench"
    for d in ("kinds", "configs", "mixes", "limits"):
        (pb / d).mkdir(parents=True)
    shutil.copy(os.path.join(PERFBENCH, "kinds", "gcn.py"),
                pb / "kinds" / "gcn_by_files.py")
    with open(os.path.join(PERFBENCH, "configs", "gcn-arxiv.json")) as f:
        conf = json.load(f)
    conf["model"]["kind"] = "gcn_by_files"
    (pb / "configs" / "twin.json").write_text(json.dumps(conf))
    shutil.copy(os.path.join(PERFBENCH, "mixes", "train.json"),
                pb / "mixes" / "train.json")
    shutil.copy(os.path.join(PERFBENCH, "limits", "gcn-arxiv.train.json"),
                pb / "limits" / "twin.train.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "twin", "file": "perfbench/configs/twin.json"}],
        "workloads": [{"name": "twin.train", "config": "twin",
                       "traffic": "train", "chips": 1}],
        "end_to_end": [{"name": "train_nodes_per_s", "unit": "nodes/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}))
    cell = tiny(load_cell("twin.train", str(tmp_path)))
    assert cell.config["model"]["kind"] == "gcn_by_files"
    assert runner.gnn_config(cell.config["model"]).kind == "gcn"
    out = runner.run_cell(cell, 2 ** 31 + 777, 1.0, False,
                          torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"] / 3 or c["limit"] == 0, name
    assert set(out["metrics"]) == {"train_nodes_per_s", "setup_s"}

"""The port's GNN examples (``repro_torch.examples``: quickstart, serve_gnn,
train_ibmb_full, dynamic_graph, inference_comparison) against the JAX
package on the CPU, at small sizes.

Each port example runs through ``main([... "--device", "cpu"])``. Where
the reference script takes the same flags it runs too, its printed lines
captured: the port prints the same lines, numbers aside, and the same
weight-independent figures (plan fingerprints, batch counts, plan bytes,
the engine's counters, the refresh audit and the swap). Where it hard-codes
its epochs, its pipeline and batchers run directly. Weights differ (the
reference initialises from a JAX key), so the port's trained parameters
are carried into the reference's trainer and engine: evaluate figures and
served logits within 1e-4 (f32 on both sides; sums in other orders).
"""
import importlib.util
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_dataset
from repro.graph.sampling import make_batcher as jax_batcher
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.serve import GNNInferenceEngine as JaxEngine
from repro.train import GNNTrainer as JaxTrainer
from repro_torch.examples import (dynamic_graph, inference_comparison,
                                  quickstart, serve_gnn, train_ibmb_full)
from repro_torch.graph.sampling import make_batcher

ATOL = RTOL = 1e-4
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def reference_main(name, argv, monkeypatch, capsys):
    """Run ``examples/<name>.py``'s ``main`` with ``argv`` and return the
    lines it printed."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def port_main(mod, argv, capsys):
    capsys.readouterr()
    out = mod.main([*argv, "--device", "cpu"])
    return out, capsys.readouterr().out.splitlines()


def template(lines):
    """The lines with every number masked: what the port must print alike
    whatever its timings and weights."""
    return [_NUM.sub("#", l) for l in lines]


def same_lines(port, ref, exact=()):
    """The port's lines match the reference's with numbers masked, and the
    lines at the indices ``exact`` match digit for digit."""
    assert template(port) == template(ref)
    for i in exact:
        assert port[i] == ref[i], i


def numpy_params(params):
    """The port's parameter tree as numpy arrays, which the reference's
    jitted functions take as they are."""
    return jax.tree_util.tree_map(lambda t: t.detach().cpu().numpy(), params,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))


def jax_cfg(cfg):
    return JaxGNNConfig(kind=cfg.kind, in_dim=cfg.in_dim, hidden=cfg.hidden,
                        out_dim=cfg.out_dim, num_layers=cfg.num_layers,
                        heads=cfg.heads, dropout=cfg.dropout)


def served_logits_hold(served, ref_plan):
    """The reference's engine on the reference's plan, with the port's
    trained parameters, answers the port's query within 1e-4 of the
    port's logits."""
    cfg = served["cfg"]
    want = JaxEngine(ref_plan, jax_cfg(cfg), numpy_params(served["params"]),
                     backend=served["backend"]).query(served["query"])
    np.testing.assert_allclose(served["logits"], np.asarray(want),
                               atol=ATOL, rtol=RTOL)


QUICKSTART_CFG = dict(variant="node", k_per_output=8,
                      max_outputs_per_batch=64, pad_multiple=32,
                      schedule="tsp")


@pytest.mark.parametrize("backend", ["segment", "bcsr"])
def test_quickstart(backend, capsys):
    got, lines = port_main(quickstart, ["--epochs", "2", "--backend",
                                        backend], capsys)
    ds = jax_dataset("tiny")
    pipe = JaxPipeline(ds, JaxConfig(**QUICKSTART_CFG, backend=backend))
    train = pipe.plan("train")
    test = pipe.plan("test", for_inference=True)
    assert (got["num_nodes"], got["num_edges"], got["num_classes"],
            got["num_train"]) == (ds.num_nodes, ds.graph.num_edges,
                                  ds.num_classes, len(ds.splits["train"]))
    assert got["train_batches"] == train.num_batches
    assert got["val_batches"] == pipe.plan(
        "val", for_inference=True).num_batches
    assert got["train_plan_nbytes"] == train.nbytes()
    assert got["fingerprint"] == test.fingerprint
    assert got["epochs_run"] == 2 and got["test_batches"] == test.num_batches
    # the reference's evaluate of the port's trained weights
    served = got["served"]
    want = JaxTrainer(jax_cfg(served["cfg"]), backend=backend).evaluate(
        numpy_params(served["params"]), test)
    assert got["test_acc"] == pytest.approx(want["acc"], abs=ATOL)
    assert got["test_loss"] == pytest.approx(want["loss"], abs=ATOL,
                                             rel=RTOL)
    served_logits_hold(served, test)
    assert got["batch_runs"] == 1
    assert template(lines) == template([
        "graph: 400 nodes, 2120 edges, 5 classes, 200 train nodes",
        "preprocessing: 0.37s → 4 train batches, plan 0.2 MB (contiguous "
        "cache + schedule + routing index)",
        f"plan round-trip: saved+loaded test_plan.npz (fingerprint "
        f"{test.fingerprint})",
        "training: best val acc 0.650 (epoch 1), 943 ms/epoch",
        "inference: test acc 0.567 in 0.00s (1 batches)",
        "serving: 16-node query → logits (16, 5) in 1.3 ms (1 batch "
        "forwards)"])
    assert lines[0] == "graph: 400 nodes, 2120 edges, 5 classes, 200 train " \
                       "nodes"
    assert lines[2].endswith(f"(fingerprint {test.fingerprint})")


def test_serve_gnn(monkeypatch, capsys):
    argv = ["--epochs", "1", "--requests", "24"]
    ref = reference_main("serve_gnn", argv, monkeypatch, capsys)
    got, lines = port_main(serve_gnn, argv, capsys)
    # the plan line (its seconds aside), the counters, the burst's forwards
    same_lines(lines, ref, exact=[4, 6])
    assert lines[0].split(" in ")[1].split("s (", 1)[1] == \
        ref[0].split(" in ")[1].split("s (", 1)[1]
    assert ref[8].startswith(f"coalesced burst of 32 concurrent requests: "
                             f"{got['burst_runs']} new batch forwards")
    pipe = JaxPipeline(jax_dataset("tiny"), JaxConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=64,
        pad_multiple=32))
    served_logits_hold(got["served"], pipe.plan("test", for_inference=True))


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_train_ibmb_full(model, tmp_path, monkeypatch, capsys):
    argv = ["--dataset", "tiny", "--model", model, "--epochs", "2"]
    ref = reference_main("train_ibmb_full", argv + [
        "--plan-dir", str(tmp_path / "ref_plans")], monkeypatch, capsys)
    got, lines = port_main(train_ibmb_full, argv + [
        "--plan-dir", str(tmp_path / "plans"),
        "--ckpt-dir", str(tmp_path / "ckpt")], capsys)
    # the dataset and fingerprint lines and the batch shapes; the
    # checkpoint line is the port's --ckpt-dir
    ref_lines = [l.replace(str(tmp_path / "ref_plans"),
                           str(tmp_path / "plans")) for l in ref]
    assert lines[0] == ref_lines[0] and lines[1] == ref_lines[1]
    assert lines[2].split("s → ")[1] == ref_lines[2].split("s → ")[1]
    ck = [i for i, l in enumerate(lines) if l.startswith("checkpointed")]
    assert lines[ck[0]] == f"checkpointed best params to {tmp_path / 'ckpt'}"
    assert template(lines[:ck[0]] + lines[ck[0] + 1:]) == template(ref_lines)
    assert got["epochs_run"] == 2 and got["hidden"] == 64
    # the saved plans load in the reference, fingerprints checked
    pipe = JaxPipeline(jax_dataset("tiny"), JaxConfig(
        variant="node", k_per_output=16, max_outputs_per_batch=1024,
        schedule="tsp"))
    test = pipe.load_plan(str(tmp_path / "plans" / "test_plan.npz"), "test",
                          for_inference=True)
    assert test.fingerprint == got["fingerprints"][2]
    # the port's checkpoint restores in the reference, bit for bit
    from repro.checkpoint import Checkpointer as JaxCheckpointer
    params = numpy_params(got["params"])
    back, _ = JaxCheckpointer(str(tmp_path / "ckpt")).restore(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), b)
    want = JaxTrainer(jax_cfg(got["cfg"])).evaluate(params, test)
    assert got["test_acc"] == pytest.approx(want["acc"], abs=ATOL)
    assert got["test_loss"] == pytest.approx(want["loss"], abs=ATOL,
                                             rel=RTOL)


def test_dynamic_graph(monkeypatch, capsys):
    argv = ["--epochs", "1", "--requests", "16"]
    ref = reference_main("dynamic_graph", argv, monkeypatch, capsys)
    got, lines = port_main(dynamic_graph, argv, capsys)
    # every line but the refresh's seconds, digit for digit
    assert len(lines) == len(ref)
    for i, (a, b) in enumerate(zip(lines, ref)):
        if a.startswith("refresh"):
            assert a.split("s: ", 1)[1] == b.split("s: ", 1)[1]
        else:
            assert a == b, i
    assert got["new_runs"] <= got["dirty"]
    pipe = JaxPipeline(jax_dataset("tiny"), JaxConfig(
        variant="node", k_per_output=8, max_outputs_per_batch=16,
        pad_multiple=32))
    served_logits_hold(got["served"], pipe.plan("test", for_inference=True))


def _same_batches(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        da, db = a.device_arrays(), b.device_arrays()
        assert sorted(da) == sorted(db)
        for k in da:
            assert np.array_equal(np.asarray(da[k]), np.asarray(db[k])), k


@pytest.mark.parametrize("name,kw", inference_comparison.BASELINES,
                         ids=[n for n, _ in inference_comparison.BASELINES])
def test_baseline_batches_are_the_reference_s(name, kw):
    from repro_torch.graph.datasets import get_dataset
    _same_batches(
        make_batcher(name, get_dataset("small"), split="test",
                     **kw).epoch_batches(0),
        jax_batcher(name, jax_dataset("small"), split="test",
                    **kw).epoch_batches(0))


def test_inference_comparison(capsys):
    got, lines = port_main(inference_comparison, ["--epochs", "2"], capsys)
    assert template(lines[:3]) == template([
        "pretrained GCN: val acc 0.590", "",
        f"{'method':22s} {'test acc':>9s} {'time (s)':>9s}"])
    names = ["ibmb_node", "ibmb_batch"] + [n for n, _ in
                                           inference_comparison.BASELINES]
    assert [l.split()[0] for l in lines[3:]] == names
    ds = jax_dataset("small")
    plans = {
        "ibmb_node": JaxPipeline(ds, JaxConfig(
            variant="node", k_per_output=8, max_outputs_per_batch=256)),
        "ibmb_batch": JaxPipeline(ds, JaxConfig(
            variant="batch", num_batches=8, max_outputs_per_batch=256))}
    trainer = JaxTrainer(jax_cfg(got["cfg"]))
    params = numpy_params(got["params"])
    for name in names:
        if name in plans:
            batches = plans[name].plan("test", for_inference=True)
        else:
            kw = dict(inference_comparison.BASELINES)[name]
            batches = jax_batcher(name, ds, split="test",
                                  **kw).epoch_batches(0)
        want = trainer.evaluate(params, batches)
        m = got["methods"][name]
        assert m["batches"] == len(batches), name
        assert m["acc"] == pytest.approx(want["acc"], abs=ATOL), name
        assert m["loss"] == pytest.approx(want["loss"], abs=ATOL,
                                          rel=RTOL), name

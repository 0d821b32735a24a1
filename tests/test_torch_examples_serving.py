"""The port's serving examples (``repro_torch.examples``: ooc_serve,
serve_async, serve_lm) against the reference scripts on the CPU, and what
every example does with ``--device cuda`` and no card.

The reference script's ``main`` runs at the same flags, its printed lines
captured: the port prints the same lines, its weight-independent figures
digit for digit (the streamed store, the lazy cache's loads, hits and
evictions, the shards a query hits; the tier's admission and swap counts).
ooc_serve and serve_lm take the reference's own initialisation through
``run(args, params=...)`` (``params_from_jax``, ``lm_params_from_jax``):
served logits within 1e-4 of the reference's engine, LM tokens identical.
serve_async trains its two tenants in the port; tenant a's parameters
carried into the reference's engine answer within 1e-4.
"""
import importlib
import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.core import IBMBConfig as JaxConfig, IBMBPipeline as JaxPipeline
from repro.graph.datasets import get_dataset as jax_dataset
from repro.models.gnn import GNNConfig as JaxGNNConfig
from repro.models.gnn import init_gnn as jax_init_gnn
from repro.models.lm import init_params as jax_init_params
from repro.serve import GNNInferenceEngine as JaxEngine
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.examples import ooc_serve, serve_async, serve_lm

ATOL = RTOL = 1e-4
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")
EXAMPLES = ("quickstart", "serve_gnn", "train_ibmb_full", "dynamic_graph",
            "ooc_serve", "serve_async", "inference_comparison", "serve_lm")


def reference_main(name, argv, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def template(lines):
    return [_NUM.sub("#", l) for l in lines]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def without(line, pattern):
    """``line`` with the first match of ``pattern`` (a timing) removed."""
    return re.sub(pattern, "", line, count=1)


def test_ooc_serve(monkeypatch, capsys):
    argv = ["--dataset", "small", "--requests", "12"]
    ref = reference_main("ooc_serve", argv, monkeypatch, capsys)
    ds = jax_dataset("small")
    mkw = dict(kind="gcn", in_dim=ds.feat_dim, hidden=64,
               out_dim=ds.num_classes, num_layers=3)
    jparams = numpy_tree(jax_init_gnn(JaxGNNConfig(**mkw),
                                      jax.random.PRNGKey(0)))
    args = ooc_serve.parser().parse_args(argv + ["--device", "cpu"])
    got = ooc_serve.run(args, params=params_from_jax(jparams, "cpu"))
    lines = capsys.readouterr().out.splitlines()
    # every line digit for digit but the build's seconds and the p50
    assert len(lines) == len(ref) == 5
    assert without(lines[0], r"in [\d.]+s") == without(ref[0], r"in [\d.]+s")
    assert without(lines[2], r"p50 \d+ us") == without(ref[2], r"p50 \d+ us")
    assert lines[4] == ref[4] and lines[4].endswith("engine: True")
    assert got["bitwise_equal"] and got["shards_hit"] == 3
    # the reference's resident engine on the same weights
    plan = JaxPipeline(ds, JaxConfig(variant="node", k_per_output=8,
                                     max_outputs_per_batch=64,
                                     pad_multiple=32)).plan(
        "test", for_inference=True)
    want = JaxEngine(plan, JaxGNNConfig(**mkw), jparams).query(got["query"])
    np.testing.assert_allclose(got["logits"], np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_ooc_serve_bcsr_matches_segment():
    """The bcsr Plan serves the same answers out of core as the segment
    one: another fingerprint, the same loads, the shards still bitwise."""
    seg = ooc_serve.main(["--dataset", "tiny", "--requests", "4",
                          "--device", "cpu"])
    bcsr = ooc_serve.main(["--dataset", "tiny", "--requests", "4",
                           "--device", "cpu", "--backend", "bcsr"])
    assert bcsr["fingerprint"] != seg["fingerprint"]
    assert (bcsr["loads"], bcsr["hits"], bcsr["shards_hit"]) == \
        (seg["loads"], seg["hits"], seg["shards_hit"])
    assert bcsr["bitwise_equal"]
    np.testing.assert_allclose(bcsr["logits"], seg["logits"], atol=ATOL,
                               rtol=RTOL)


def test_serve_async(monkeypatch, capsys):
    argv = ["--epochs", "1", "--requests", "10"]
    ref = reference_main("serve_async", argv, monkeypatch, capsys)
    got = serve_async.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ref)
    assert template(lines[:5]) == template(ref[:5])
    assert lines[3] == ref[3] == \
        "admission: deadline 0.01ms → rejected on arrival"
    # the swap: the version and swap counts (what it invalidates depends
    # on how far the clients got)
    assert lines[5].startswith("swap('a') mid-stream: plan v1, ")
    assert lines[5].endswith("(swaps: a=1, b=0)") and \
        ref[5].endswith("(swaps: a=1, b=0)")
    assert lines[7].split(" in ")[0] == ref[7].split(" in ")[0] == \
        "30 requests from 3 clients"
    assert template(lines[8:10]) == template(ref[8:10])
    assert [l.split(":")[0] for l in lines[10:]] == \
        [l.split(":")[0] for l in ref[10:]] == ["  tenant 'a'", "  tenant 'b'"]
    assert got["rejected"] and got["swaps"] == {"a": 1, "b": 0}
    served = got["served"]
    ds = jax_dataset("tiny")
    plan = JaxPipeline(ds, JaxConfig(variant="node", k_per_output=8,
                                     max_outputs_per_batch=32,
                                     pad_multiple=16)).plan(
        "test", for_inference=True)
    assert plan.fingerprint == got["fingerprint"]
    cfg = served["cfg"]
    want = JaxEngine(plan, JaxGNNConfig(
        kind="gcn", in_dim=cfg.in_dim, hidden=cfg.hidden,
        out_dim=cfg.out_dim, num_layers=cfg.num_layers),
        jax.tree_util.tree_map(lambda t: t.numpy(), served["params"],
                               is_leaf=lambda x: isinstance(x, torch.Tensor))
    ).query(served["query"])
    np.testing.assert_allclose(served["logits"], np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-1.5b"])
def test_serve_lm_tokens_are_the_reference_s(arch, monkeypatch, capsys):
    argv = ["--arch", arch, "--requests", "4"]
    ref = reference_main("serve_lm", argv, monkeypatch, capsys)
    params = lm_params_from_jax(numpy_tree(jax_init_params(
        jax_get_smoke(arch), jax.random.PRNGKey(0))), "cpu")
    args = serve_lm.parser().parse_args(argv + ["--smoke", "--device", "cpu"])
    got = serve_lm.run(args, params=params)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ref) == 4
    assert without(lines[0], r", [\d.]+s \(") == \
        without(ref[0], r", [\d.]+s \(")
    assert lines[1:] == ref[1:]
    assert got["completed"] == 4 and got["evicted"] == 0
    assert all(len(t) == 8 for t in got["tokens"])


def test_serve_lm_multi_codebook_returns_early(monkeypatch, capsys):
    ref = reference_main("serve_lm", ["--arch", "musicgen-large"],
                         monkeypatch, capsys)
    got = serve_lm.main(["--arch", "musicgen-large", "--smoke",
                         "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == ref
    assert got == {"arch": "musicgen-large", "skipped": True}


def test_serve_lm_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_lm", "--smoke",
         "--device", "cpu", "--requests", "2", "--new-tokens", "3"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("llama3.2-1b (llama3.2-1b-smoke): 2/2 "
                                  "requests in ")


@pytest.mark.parametrize("name", EXAMPLES)
def test_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    argv = ["--device", "cuda"] + (["--smoke"] if name == "serve_lm" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_every_example_defaults_to_the_card():
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        src = open(mod.__file__, encoding="utf-8").read()
        assert "add_device(ap)" in src, name
    from repro_torch.examples._common import add_device, plan_backend
    import argparse
    ap = argparse.ArgumentParser()
    add_device(ap)
    assert ap.parse_args([]).device == "cuda"
    assert [plan_backend(b) for b in ("segment", "bcsr", "dense", "auto")] \
        == ["segment", "bcsr", "segment", "bcsr"]

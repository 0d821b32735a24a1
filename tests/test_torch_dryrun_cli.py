"""``python -m repro_torch.launch.dryrun`` as a user runs it on a CPU with
no card: production cells of the (16, 16) mesh on a fake process group,
written as the reference's JSON fields at H100 constants. Each command runs in its own process, as the reference's
dry run must."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *argv, "--out", str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("shape,mesh,chips", [
    ("prefill_32k", "single", 256)])
def test_llama_cell_runs_on_the_cpu(tmp_path, shape, mesh, chips):
    out = _run(tmp_path, "--arch", "llama3.2-1b", "--shape", shape,
               "--mesh", mesh)
    assert "memory_s" in out or "compute_s" in out
    with open(tmp_path / f"llama3.2-1b__{shape}__{mesh}.json") as f:
        cell = json.load(f)
    assert "error" not in cell, cell.get("traceback")
    assert cell["chips"] == chips
    h, r = cell["hlo"], cell["roofline"]
    assert h["collective_bytes"] > 0
    assert r["compute_s"] == h["flops"] / 989e12
    assert r["memory_s"] == h["bytes"] / 3.35e12
    assert r["collective_s"] == h["collective_bytes"] / 900e9
    assert cell["memory"]["hbm_fraction"] == \
        cell["memory"]["peak_bytes"] / 80e9


def test_gnn_cell_with_the_shmap_variant(tmp_path):
    _run(tmp_path, "--arch", "gnn-gcn", "--mesh", "single", "--gnn-shmap")
    with open(tmp_path / "gnn-gcn__train_products__single.json") as f:
        cell = json.load(f)
    assert cell["chips"] == 256
    assert cell["hlo"]["collectives"]["all-reduce"] > 0
    assert cell["model_flops_per_chip"] == \
        dryrun._gnn_model_flops(dryrun.GNN_SHAPE, 256) / 256


def test_long_500k_is_skipped_for_a_full_attention_arch(tmp_path):
    _run(tmp_path, "--arch", "llama3.2-1b", "--shape", "long_500k")
    with open(tmp_path / "llama3.2-1b__long_500k__single.json") as f:
        assert "skipped" in json.load(f)
    # a cell whose JSON exists is not run again
    assert "[skip]" in _run(tmp_path, "--arch", "llama3.2-1b", "--shape",
                            "long_500k")

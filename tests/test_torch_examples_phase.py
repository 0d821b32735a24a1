"""``chip_smoke.py``'s examples phase rehearsed on the CPU at a tiny size:
every example's ``main`` with tiny arguments, the CPU's run of the same
GNN examples held to it figure by figure, the trained weights served and
evaluated again, serve_lm twice and one prefill of what it served. On the
CPU no kernel launches, so the launch counts are only printed; the card
runs the phase at its real size."""
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

TINY = (("quickstart", ["--backend", "bcsr", "--epochs", "1"]),
        ("serve_gnn", ["--dataset", "tiny", "--backend", "bcsr",
                       "--epochs", "1", "--requests", "6"]),
        ("train_ibmb_full", ["--dataset", "tiny", "--backend", "bcsr",
                             "--epochs", "1"]),
        ("dynamic_graph", ["--dataset", "tiny", "--backend", "bcsr",
                           "--epochs", "1", "--requests", "6"]),
        ("ooc_serve", ["--dataset", "tiny", "--backend", "bcsr",
                       "--requests", "4"]),
        ("serve_async", ["--dataset", "tiny", "--backend", "bcsr",
                         "--epochs", "1", "--requests", "4"]),
        ("inference_comparison", ["--epochs", "1"]),
        ("serve_lm", ["--smoke", "--requests", "3", "--new-tokens", "4"]))


def test_the_examples_phase_rehearses_on_the_cpu(tmp_path, capsys):
    assert [n for n, _ in TINY] == [n for n, _ in chip_smoke.EXAMPLES]
    ctx = types.SimpleNamespace(
        torch=torch, np=np, dev=torch.device("cpu"), build=build,
        on_card=False, sync=lambda: None, note=None, work=str(tmp_path),
        examples=TINY, cpu_examples=lambda: chip_smoke.examples_on_cpu(
            TINY, str(tmp_path / "cpu")))
    chip_smoke.examples_phase(ctx)
    out = capsys.readouterr().out
    for name, _ in TINY[:-1]:
        assert f"example {name}: " in out and "figures equal to the CPU" \
            in out.split(f"example {name}: ")[1].splitlines()[0]
    assert "the same 12 greedy tokens in a second run" in out
    assert ctx.example_launches == {"flash_attention": 0}


def test_each_fit_s_launch_count():
    """``example_spmm_want`` from an example's figures: 2 launches per
    layer a train step, 1 per layer an evaluated or served batch."""
    fig = dict(backend="bcsr", num_layers=3, train_batches=4, val_batches=2,
               epochs_run=5, test_batches=1, batch_runs=2,
               total_batch_runs=7)
    fit = 2 * 3 * 4 * 5 + 3 * 2 * 5
    want = chip_smoke.example_spmm_want
    assert want("quickstart", fig) == fit + 3 * (1 + 2)
    assert want("serve_gnn", fig) == fit + 3 * 7
    assert want("train_ibmb_full", fig) == fit + 3
    assert want("serve_async", dict(
        fig, epochs_run={"a": 5, "b": 2},
        engines={"a": {"batch_runs": 4}, "b": {"batch_runs": 1}})) == \
        fit + (2 * 3 * 4 * 2 + 3 * 2 * 2) + 3 * 5
    assert want("ooc_serve", fig) is None
    assert want("quickstart", dict(fig, backend="segment")) == 0
    assert want("serve_lm", {}) == 0

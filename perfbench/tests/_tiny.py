"""A cell of ``BENCHMARK.json`` cut to a size a CPU test run holds: a
3,000-node graph, 10 classes, 32 features, hidden 64, 128 outputs a
batch; everything else as the configuration states it."""
import copy
import dataclasses
import time

import torch

from perfbench.harness.cell import load_cell
from perfbench.harness.runner import run_cell

SEED = 2 ** 31 + 12345


def tiny_cell(name, **mix):
    return tiny(load_cell(name), **mix)


def tiny(cell, **mix):
    """``cell`` at the tiny size, its mix's parameters replaced by
    ``mix``."""
    c = copy.deepcopy(cell.config)
    c["dataset"].update(num_nodes=3000, avg_degree=8.0, num_classes=10,
                        feat_dim=32)
    c["model"].update(in_dim=32, out_dim=10, hidden=64)
    c["ibmb"].update(max_outputs_per_batch=128)
    return dataclasses.replace(cell, config=c, mix=dict(cell.mix, **mix))


def run_tiny(name, seconds=1.0, traced=False, seed=SEED, **mix):
    """One run of the tiny cell on the CPU, with the harness's look for a
    card skipped."""
    return run_cell(tiny_cell(name, **mix), seed, seconds, traced,
                    torch.device("cpu"), time.perf_counter())

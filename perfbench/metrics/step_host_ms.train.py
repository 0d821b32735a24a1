"""step_host_ms.train: the host's dispatch of one training step, the mean
self time of ``train.step`` less its loss read; moves train_nodes_per_s.
"""
from perfbench.harness import spans


def read(ctx):
    return spans.step_host_ms(spans.snapshot())

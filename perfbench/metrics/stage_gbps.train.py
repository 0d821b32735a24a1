"""stage_gbps.train: bytes the loader's worker staged in the training
window over the seconds of its staging spans (``loader.stage``); moves
train_nodes_per_s.
"""
from perfbench.harness import spans


def read(ctx):
    return spans.stage_gbps(spans.snapshot(), "loader.stage")

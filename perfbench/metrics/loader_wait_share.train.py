"""loader_wait_share.train: share of the training epochs the step loop
waited on the loader's queue (``loader.wait`` over ``train.epoch``);
moves train_nodes_per_s.
"""
from perfbench.harness import spans


def read(ctx):
    return spans.loader_wait_share(spans.snapshot())

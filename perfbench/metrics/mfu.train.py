"""mfu.train: the training window's model operations at the card's float32
peak; moves train_nodes_per_s.
"""
from perfbench.harness.readers import mfu as read  # noqa: F401

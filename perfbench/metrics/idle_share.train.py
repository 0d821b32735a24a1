"""idle_share.train: share of the training window with nothing on the
device; moves train_nodes_per_s.
"""
from perfbench.harness.readers import idle_share as read  # noqa: F401

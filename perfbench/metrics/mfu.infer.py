"""mfu.infer: the inference passes' model operations at the card's float32
peak; moves infer_nodes_per_s.
"""
from perfbench.harness.readers import mfu as read  # noqa: F401

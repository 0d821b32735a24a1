"""idle_share.infer: share of the inference passes with nothing on the
device; moves infer_nodes_per_s.
"""
from perfbench.harness.readers import idle_share as read  # noqa: F401

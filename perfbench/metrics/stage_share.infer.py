"""stage_share.infer: host-to-device copies' share of the device's busy
time over the inference passes; moves infer_nodes_per_s.
"""
from perfbench.harness.readers import stage_share as read  # noqa: F401

"""stage_share.train: host-to-device copies' share of the device's busy
time in the training window; moves train_nodes_per_s.
"""
from perfbench.harness.readers import stage_share as read  # noqa: F401

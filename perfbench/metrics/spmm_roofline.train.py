"""spmm_roofline.train: the block-CSR SpMM kernels' least time over their
device time in the training window; moves train_nodes_per_s.
"""
from perfbench.harness.readers import spmm_roofline as read  # noqa: F401

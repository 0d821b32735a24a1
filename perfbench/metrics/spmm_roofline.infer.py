"""spmm_roofline.infer: the block-CSR SpMM kernels' least time over their
device time over the inference passes; moves infer_nodes_per_s.
"""
from perfbench.harness.readers import spmm_roofline as read  # noqa: F401

"""Influence-based mini-batching (IBMB), the port's copy of ``repro.core``.

Pipeline:  influence ≈ PPR  →  output-node partitioning  →  auxiliary-node
selection  →  induced padded subgraph batches  →  batch scheduling.
Host-side numpy throughout; plans are bitwise-identical to the JAX
package's and share its npz format.
"""
from repro_torch.core.ppr import (
    push_appr, topic_sensitive_ppr, dense_ppr, heat_kernel, TopKPPR,
    ppr_dirty_roots, push_appr_incremental,
)
from repro_torch.core.partition import (
    ppr_distance_partition, graph_partition, random_partition,
)
from repro_torch.core.aux_selection import node_wise_aux, batch_wise_aux
from repro_torch.core.batches import PaddedBatch, build_batches, BatchCache
from repro_torch.core.plan import (
    Plan, RoutingIndex, PlanFormatError, plan_fingerprint, check_routing,
)
from repro_torch.core.scheduling import (
    label_distributions, pairwise_kl_distance, tsp_max_order, weighted_sampling_order,
)
from repro_torch.core.pipeline import IBMBPipeline, IBMBConfig
from repro_torch.core import autotune

__all__ = [
    "autotune",
    "push_appr", "topic_sensitive_ppr", "dense_ppr", "heat_kernel", "TopKPPR",
    "ppr_dirty_roots", "push_appr_incremental",
    "ppr_distance_partition", "graph_partition", "random_partition",
    "node_wise_aux", "batch_wise_aux",
    "PaddedBatch", "build_batches", "BatchCache",
    "Plan", "RoutingIndex", "PlanFormatError", "plan_fingerprint",
    "check_routing",
    "label_distributions", "pairwise_kl_distance", "tsp_max_order", "weighted_sampling_order",
    "IBMBPipeline", "IBMBConfig",
]

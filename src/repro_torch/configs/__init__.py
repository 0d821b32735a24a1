"""The LM architecture registry and input-shape cells: a copy of
``repro.configs`` (registry, shapes, the ten arch modules and the paper's
three GNN configs ``gnn_gcn``, ``gnn_sage`` and ``gnn_gat``), with only its
imports changed."""
from repro_torch.configs.registry import get_config, list_archs, get_smoke_config, ARCH_IDS

__all__ = ["get_config", "list_archs", "get_smoke_config", "ARCH_IDS"]

"""The LM architecture registry and input-shape cells: a copy of
``repro.configs`` (registry, shapes and the ten arch modules), with only its
imports changed. The GNN configs stay with ``repro_torch.models.gnn``."""
from repro_torch.configs.registry import get_config, list_archs, get_smoke_config, ARCH_IDS

__all__ = ["get_config", "list_archs", "get_smoke_config", "ARCH_IDS"]

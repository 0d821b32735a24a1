from repro_torch.models.gnn.models import GNNConfig, init_gnn, gnn_apply
from repro_torch.models.gnn.ops import validate_batch_for_backend
from repro_torch.models.gnn.policy import BackendPolicy

__all__ = ["GNNConfig", "init_gnn", "gnn_apply",
           "validate_batch_for_backend", "BackendPolicy"]

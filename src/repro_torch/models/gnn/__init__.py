from repro_torch.models.gnn.models import (
    GNNConfig, init_gnn, gnn_apply, output_logits, masked_xent,
    masked_accuracy)
from repro_torch.models.gnn.ops import validate_batch_for_backend
from repro_torch.models.gnn.policy import BackendPolicy

__all__ = ["GNNConfig", "init_gnn", "gnn_apply", "output_logits",
           "masked_xent", "masked_accuracy", "validate_batch_for_backend",
           "BackendPolicy"]

from repro_torch.train.gnn_trainer import (
    GNNTrainer, NonFiniteGradError, TrainResult, as_host_batches, step_rng,
)

__all__ = ["GNNTrainer", "NonFiniteGradError", "TrainResult",
           "as_host_batches", "step_rng"]

from repro_torch.checkpoint.checkpointer import (
    Checkpointer, CheckpointCorruptError, CheckpointError,
    all_steps, save_pytree, load_pytree, latest_step,
)

__all__ = ["Checkpointer", "CheckpointCorruptError", "CheckpointError",
           "all_steps", "save_pytree", "load_pytree", "latest_step"]

from repro_torch.data.loader import PrefetchLoader, consume, stage_batch

__all__ = ["PrefetchLoader", "consume", "stage_batch"]

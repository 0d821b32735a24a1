from repro_torch.serve.common import (
    CircuitBreaker, ServeClosed, ServeError, ServeExpired, ServeFuture,
    ServeRejected, ServeUnavailable, SlotPool, SystemClock)
from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest

__all__ = [
    "CircuitBreaker", "GNNInferenceEngine", "GNNRequest", "ServeClosed",
    "ServeError", "ServeExpired", "ServeFuture", "ServeRejected",
    "ServeUnavailable", "SlotPool", "SystemClock",
]

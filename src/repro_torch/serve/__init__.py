from repro_torch.serve.async_engine import (
    AsyncGNNEngine, AsyncServeConfig, ServeStats)
from repro_torch.serve.common import (
    CircuitBreaker, ServeClosed, ServeError, ServeExpired, ServeFuture,
    ServeRejected, ServeUnavailable, SlotPool, SystemClock)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest

__all__ = [
    "AsyncGNNEngine", "AsyncServeConfig", "CircuitBreaker",
    "GNNInferenceEngine", "GNNRequest", "Request", "ServeClosed",
    "ServeEngine", "ServeError", "ServeExpired", "ServeFuture",
    "ServeRejected", "ServeStats", "ServeUnavailable", "SlotPool",
    "SystemClock",
]

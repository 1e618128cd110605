"""Serving engines of the port, the request-stream scheduler and its
degradation policy."""
from repro_torch.serving.degrade import (BreakerConfig, CircuitBreaker,
                                         DegradePolicy, DegradeTier)
from repro_torch.serving.engine import (ClassifyResult, GenerationResult,
                                        KNNServeEngine, NonNeuralServeEngine,
                                        ServeEngine)
from repro_torch.serving.scheduler import (RequestResult, RequestScheduler,
                                           ServingStats, poisson_trace,
                                           replay_trace)

__all__ = ["BreakerConfig", "CircuitBreaker", "ClassifyResult",
           "DegradePolicy", "DegradeTier", "GenerationResult",
           "KNNServeEngine", "NonNeuralServeEngine", "RequestResult",
           "RequestScheduler", "ServeEngine", "ServingStats",
           "poisson_trace", "replay_trace"]

"""Serving engines of the port, the request-stream scheduler, its
brownout ladder and degradation policy, the multi-tenant model store and
the int8 codec."""
from repro_torch.serving.degrade import (BreakerConfig, CircuitBreaker,
                                         DegradePolicy, DegradeTier,
                                         build_ladder)
from repro_torch.serving.engine import (ClassifyResult, GenerationResult,
                                        GroupClassifyResult, KNNServeEngine,
                                        NonNeuralServeEngine, ServeEngine,
                                        TunedArm)
from repro_torch.serving.model_store import (ModelStore, PoisonedParamsError,
                                             validate_finite)
from repro_torch.serving.scheduler import (RequestResult, RequestScheduler,
                                           ServingStats, poisson_trace,
                                           replay_trace)
from repro_torch.serving import quant  # noqa: E402

__all__ = ["BreakerConfig", "CircuitBreaker", "ClassifyResult",
           "DegradePolicy", "DegradeTier", "GenerationResult",
           "GroupClassifyResult", "KNNServeEngine", "ModelStore",
           "NonNeuralServeEngine", "PoisonedParamsError", "RequestResult",
           "RequestScheduler", "ServeEngine", "ServingStats",
           "TunedArm", "build_ladder", "poisson_trace", "quant",
           "replay_trace", "validate_finite"]

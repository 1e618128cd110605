"""Serving engines of the port."""
from repro_torch.serving.engine import (ClassifyResult, GenerationResult,
                                        KNNServeEngine, NonNeuralServeEngine,
                                        ServeEngine)

__all__ = ["ClassifyResult", "GenerationResult", "KNNServeEngine",
           "NonNeuralServeEngine", "ServeEngine"]

"""Serving engines of the port."""
from repro_torch.serving.engine import (ClassifyResult, KNNServeEngine,
                                        NonNeuralServeEngine)

__all__ = ["ClassifyResult", "KNNServeEngine", "NonNeuralServeEngine"]

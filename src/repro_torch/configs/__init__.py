"""Model and serving configs of the port's LM stack."""
from repro_torch.configs.base import (AttnConfig, ModelConfig,  # noqa: F401
                                      ServeConfig, reduced)

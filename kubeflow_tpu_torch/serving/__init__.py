"""Serving engine and HTTP server of the PyTorch port."""

from kubeflow_tpu_torch.serving.engine import (
    EngineOverloaded,
    GenerationRequest,
    GenerationResult,
    ServingConfig,
    ServingEngine,
    init_int8,
)
from kubeflow_tpu_torch.serving.server import ServingServer

__all__ = [
    "EngineOverloaded", "GenerationRequest", "GenerationResult",
    "ServingConfig", "ServingEngine", "ServingServer", "init_int8",
]

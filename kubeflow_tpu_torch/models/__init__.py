"""Models of the PyTorch port."""

from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from kubeflow_tpu_torch.models.registry import get_model, list_models

__all__ = ["Llama", "LlamaConfig", "Mixtral", "MixtralConfig", "get_model",
           "list_models"]

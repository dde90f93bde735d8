"""Models of the PyTorch port."""

from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from kubeflow_tpu_torch.models.registry import (
    get_model,
    list_models,
    register_model,
)
from kubeflow_tpu_torch.models.resnet import ResNet, ResNetConfig
from kubeflow_tpu_torch.models.vit import ViT, ViTConfig

__all__ = ["Llama", "LlamaConfig", "Mixtral", "MixtralConfig", "ResNet",
           "ResNetConfig", "ViT", "ViTConfig", "get_model", "list_models",
           "register_model"]

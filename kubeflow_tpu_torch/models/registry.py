"""Model registry: name -> (module class, config factory), the names of
kubeflow_tpu.models.registry, so ``KFTPU_SERVING_MODEL``, ``KFTPU_MODEL``
and the image benches resolve as they do for the JAX package;
:func:`register_model` adds one."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from kubeflow_tpu_torch.models.resnet import ResNet, ResNetConfig
from kubeflow_tpu_torch.models.vit import ViT, ViTConfig

_REGISTRY: Dict[str, Tuple[type, Callable[..., object]]] = {
    "llama3-8b": (Llama, LlamaConfig.llama3_8b),
    "llama3-70b": (Llama, LlamaConfig.llama3_70b),
    "llama-tiny": (Llama, LlamaConfig.tiny),
    "mixtral-8x7b": (Mixtral, MixtralConfig.mixtral_8x7b),
    "mixtral-tiny": (Mixtral, MixtralConfig.tiny),
    "resnet50": (ResNet, ResNetConfig.resnet50),
    "resnet101": (ResNet, ResNetConfig.resnet101),
    "resnet-tiny": (ResNet, ResNetConfig.tiny),
    "vit-l16": (ViT, ViTConfig.vit_l16),
    "vit-b16": (ViT, ViTConfig.vit_b16),
    "vit-tiny": (ViT, ViTConfig.tiny),
}


def register_model(name: str, module_cls: type, config_factory) -> None:
    if name in _REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _REGISTRY[name] = (module_cls, config_factory)


def get_model(name: str, **config_kw):
    """Returns (module instance, config). Parameters are allocated
    uninitialised on the current default device (``with torch.device(d)``)
    in the config's ``param_dtype``."""
    try:
        module_cls, factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    cfg = factory(**config_kw)
    return module_cls(cfg), cfg


def list_models():
    return sorted(_REGISTRY)

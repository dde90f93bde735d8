"""Model registry: name -> (module class, config factory), the names of
kubeflow_tpu.models.registry that this port serves, so
``KFTPU_SERVING_MODEL`` resolves as it does for the JAX server."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.models.mixtral import Mixtral, MixtralConfig

_REGISTRY: Dict[str, Tuple[type, Callable[..., object]]] = {
    "llama3-8b": (Llama, LlamaConfig.llama3_8b),
    "llama3-70b": (Llama, LlamaConfig.llama3_70b),
    "llama-tiny": (Llama, LlamaConfig.tiny),
    "mixtral-8x7b": (Mixtral, MixtralConfig.mixtral_8x7b),
    "mixtral-tiny": (Mixtral, MixtralConfig.tiny),
}


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

"""Which device the port runs on.

Entry points run on ``cuda`` unless the caller asks for the CPU. There is
no silent CPU fallback: asking for CUDA (explicitly or by default) where
``torch.cuda.is_available()`` is False raises.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device raises when no card is
    visible; ``"cpu"`` is only ever taken when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU unless "
            "the caller asks for the CPU (device='cpu', or KFTPU_PLATFORM=cpu "
            "for the server)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def platform_device() -> torch.device:
    """The ``KFTPU_PLATFORM`` contract of the JAX server: ``cpu`` selects
    the CPU; anything else, or unset, selects ``cuda``."""
    plat = os.environ.get("KFTPU_PLATFORM", "").strip().lower()
    return resolve_device("cpu" if plat == "cpu" else None)


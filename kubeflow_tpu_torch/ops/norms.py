"""Normalisation ops (f32 statistics regardless of activation dtype)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim; stats in f32, output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)

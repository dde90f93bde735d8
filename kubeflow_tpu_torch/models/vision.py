"""Layers the image models share (``models/resnet.py``, ``models/vit.py``):
flax ``nn.Conv`` and ``nn.Dense`` with the JAX package's rounding points.

Activations keep the JAX layout, NHWC ([B, H, W, C], contiguous). A
convolution reads them as the NCHW view ``x.permute(0, 3, 1, 2)``, which
is channels-last in memory, so cuDNN takes its NHWC kernels and returns a
channels-last result whose NHWC view is contiguous again: nothing is
copied between the convolutions and the kernels that read their outputs
(K19 raises on a tensor that is not). The products and convolutions stay
library calls (cuBLAS, cuDNN), as XLA computes them outside any Pallas
kernel. Parameters are stored in ``param_dtype`` and cast to the
activation dtype at each product; a bias is added after the product is
rounded, as flax adds it (a GEMM's fused bias epilogue adds before).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC activations: weight [out, in, kh, kw] (the
    JAX kernel [kh, kw, in, out] transposed), explicit symmetric padding,
    an optional bias [out] added in the activation dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int, padding: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, *kernel, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.empty(out_ch, dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, in] -> [B, H', W', out] in the activation dtype."""
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    @torch.no_grad()
    def init_variance_scaling(self, scale: float, mode: str, generator,
                              distribution: str = "normal") -> None:
        """jax.nn.initializers.variance_scaling over the JAX kernel [kh, kw,
        in, out] (receptive field kh kw): "normal" N(0, scale / fan), or
        "uniform" U(-sqrt(3 scale / fan), +); fan is fan_in, fan_out or
        their mean ("fan_avg"). The bias is zeroed."""
        out_ch, in_ch, kh, kw = self.weight.shape
        fans = {"fan_in": in_ch * kh * kw, "fan_out": out_ch * kh * kw}
        fans["fan_avg"] = (fans["fan_in"] + fans["fan_out"]) / 2
        var = scale / fans[mode]
        if distribution == "normal":
            self.weight.normal_(0.0, math.sqrt(var), generator=generator)
        else:
            lim = math.sqrt(3.0 * var)
            self.weight.uniform_(-lim, lim, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``DenseGeneral`` with a bias: weight [out, in]
    (the JAX kernel flattened to [in, out], transposed), bias [out]."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype))

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """x @ W.T in the activation dtype, without the bias."""
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.product(x) + self.bias.to(self.dtype)

    @torch.no_grad()
    def init_xavier_uniform(self, generator) -> None:
        """jax.nn.initializers.xavier_uniform over [in, out]; zero bias."""
        fan_out, fan_in = self.weight.shape
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        self.weight.uniform_(-lim, lim, generator=generator)
        self.bias.zero_()

    @torch.no_grad()
    def init_zeros(self) -> None:
        self.weight.zero_()
        self.bias.zero_()


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    1 - rate (a draw from ``generator``) and scale it by 1 / (1 - rate);
    rate 0 is the identity. The draws are PyTorch's, not JAX's."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout > 0 in training needs a generator (flax "
                         "needs a 'dropout' rng)")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))

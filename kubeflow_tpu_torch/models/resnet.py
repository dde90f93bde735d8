"""ResNet (v1.5) for image classification, the port of
``kubeflow_tpu.models.resnet`` (BASELINE config 1, ResNet-50).

NHWC activations in the activation dtype (bf16), f32 parameters and f32
batch-norm statistics, as the JAX model. The convolutions are cuDNN's
(``models/vision.py::Conv``, channels-last, nothing copied); every flax
``BatchNorm`` with the ReLU after it, and each bottleneck block's closing
``relu(bn3(y) + residual)``, is one call of K19 (``ops/batch_norm.py``):
53 a forward pass of ResNet-50. The max pool is ``F.max_pool2d`` (3, 2,
padding 1, which pads with -inf as ``nn.max_pool`` does) and the global
mean sums in f32 and rounds once, as ``jnp.mean`` of bf16 does; both stay
library calls.

The running statistics are buffers (``mean``, ``var`` of each
``BatchNorm``): the JAX ``batch_stats`` collection. ``forward(images,
train=True)`` normalises with the batch's statistics and updates the
buffers in place (flax's momentum 0.9 is the old value's weight);
``train=False`` uses the buffers and changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.llama import DtypeLike, as_dtype
from kubeflow_tpu_torch.models.vision import Conv, Dense
from kubeflow_tpu_torch.ops.batch_norm import batch_norm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    dtype: DtypeLike = torch.bfloat16
    param_dtype: DtypeLike = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))
        object.__setattr__(self, "stage_sizes", tuple(self.stage_sizes))

    @classmethod
    def resnet50(cls, **kw) -> "ResNetConfig":
        return cls(stage_sizes=(3, 4, 6, 3), **kw)

    @classmethod
    def resnet101(cls, **kw) -> "ResNetConfig":
        return cls(stage_sizes=(3, 4, 23, 3), **kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        kw.setdefault("stage_sizes", (1, 1))
        kw.setdefault("width", 8)
        kw.setdefault("num_classes", 10)
        return cls(**kw)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last dim:
    scale and bias parameters, the running ``mean`` and ``var`` f32
    buffers; the ReLU and the residual add after it in the same K19
    call."""

    def __init__(self, channels: int, cfg: ResNetConfig):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels,
                                              dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(channels, dtype=cfg.param_dtype))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool, *,
                residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        return batch_norm(x, self.scale.float(), self.bias.float(),
                          self.mean, self.var, train=train,
                          residual=residual, relu=relu)

    @torch.no_grad()
    def reset(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)


def _conv(in_ch, out_ch, k, stride, cfg) -> Conv:
    return Conv(in_ch, out_ch, (k, k), stride, k // 2, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig, in_ch: int, features: int,
                 strides: int):
        super().__init__()
        self.conv1 = _conv(in_ch, features, 1, 1, cfg)
        self.bn1 = BatchNorm(features, cfg)
        self.conv2 = _conv(features, features, 3, strides, cfg)
        self.bn2 = BatchNorm(features, cfg)
        self.conv3 = _conv(features, 4 * features, 1, 1, cfg)
        self.bn3 = BatchNorm(4 * features, cfg)
        # The JAX block projects the residual where its shape differs from
        # the output's: another width, or a stride.
        self.proj = in_ch != 4 * features or strides != 1
        if self.proj:
            self.conv_proj = _conv(in_ch, 4 * features, 1, strides, cfg)
            self.bn_proj = BatchNorm(4 * features, cfg)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = self.bn1(self.conv1(x), train, relu=True)
        y = self.bn2(self.conv2(y), train, relu=True)
        residual = (self.bn_proj(self.conv_proj(x), train) if self.proj
                    else x)
        return self.bn3(self.conv3(y), train, residual=residual, relu=True)


class ResNet(nn.Module):
    """images [B, H, W, 3] NHWC -> logits [B, num_classes] f32. Parameters
    are created uninitialised in ``param_dtype`` on the current default
    device; :meth:`init_weights` fills them, or a state dict is loaded."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_init = Conv(3, cfg.width, (7, 7), 2, 3, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype)
        self.bn_init = BatchNorm(cfg.width, cfg)
        self.blocks = []
        in_ch = cfg.width
        for i, n_blocks in enumerate(cfg.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                block = BottleneckBlock(cfg, in_ch, cfg.width * 2 ** i,
                                        strides)
                self.add_module(f"stage{i}_block{j}", block)
                self.blocks.append(block)
                in_ch = 4 * cfg.width * 2 ** i
        self.head = Dense(in_ch, cfg.num_classes, dtype=cfg.dtype,
                          param_dtype=cfg.param_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initialisers: convolutions variance_scaling(2.0,
        "fan_out", "normal"), BatchNorm scale 1, bias 0 and running
        statistics 0 and 1, the head zeros. In place, from ``generator``
        (the numbers differ from JAX's)."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.init_variance_scaling(2.0, "fan_out", generator)
            elif isinstance(m, BatchNorm):
                m.reset()
        self.head.init_zeros()

    def forward(self, images: torch.Tensor, *, train: bool = True
                ) -> torch.Tensor:
        cfg = self.cfg
        x = self.bn_init(self.conv_init(images.to(cfg.dtype)), train,
                         relu=True)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        for block in self.blocks:
            x = block(x, train)
        x = torch.mean(x, dim=(1, 2), dtype=torch.float32).to(cfg.dtype)
        return self.head(x).float()


def batch_norm_calls(cfg: ResNetConfig) -> int:
    """K19 calls a forward pass makes (and a backward pass): bn_init, three
    a block and one a projected block (ResNet-50: 1 + 48 + 4 = 53)."""
    blocks = sum(cfg.stage_sizes)
    return 1 + 3 * blocks + len(cfg.stage_sizes)

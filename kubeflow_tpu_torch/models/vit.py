"""Vision Transformer, the port of ``kubeflow_tpu.models.vit`` (the HPO
trial workload of BASELINE config 4, ViT-L/16; ViT-B/16 beside it).

The JAX model's rounding points: bf16 activations, f32 parameters cast at
each product, biases added after the product is rounded, the residual
adds in bf16, LayerNorm statistics in f32, logits f32. The element-wise
work runs in the port's kernels on the card: every flax ``LayerNorm``
(ln1, ln2, ln_final: 2L + 1 a pass) is K20 (``ops/layer_norm.py``), the
MLP's bias add + ``nn.gelu`` (tanh form) K21 (``ops/gelu.py``) after a
bias-free ``mlp_in`` product, and the non-causal attention over the S =
N + 1 tokens ``ops/flash_attention.py::flash_attention`` (K1 forward, K2
backward; head_dim 64 at ViT-B/16 and ViT-L/16). The stride-p patch
embedding is a cuDNN convolution and the projections are cuBLAS products.

Dropout (``cfg.dropout``) applies in training from an explicit
``torch.Generator`` (``forward(train=True, generator=g)``), as flax's
needs a "dropout" rng; eval is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from kubeflow_tpu_torch.models.llama import DtypeLike, as_dtype
from kubeflow_tpu_torch.models.vision import Conv, Dense, dropout
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.gelu import bias_gelu
from kubeflow_tpu_torch.ops.layer_norm import layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    embed_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    dropout: float = 0.0
    dtype: DtypeLike = torch.bfloat16
    param_dtype: DtypeLike = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))

    @classmethod
    def vit_l16(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def vit_b16(cls, **kw) -> "ViTConfig":
        return cls(embed_dim=768, num_layers=12, num_heads=12, mlp_dim=3072,
                   **kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("num_classes", 10)
        kw.setdefault("embed_dim", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("mlp_dim", 128)
        return cls(**kw)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6): scale and bias [E]."""

    def __init__(self, dim: int, cfg: ViTConfig):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale.float(), self.bias.float())

    @torch.no_grad()
    def reset(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        E, M = cfg.embed_dim, cfg.mlp_dim
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.ln1 = LayerNorm(E, cfg)
        self.q, self.k, self.v = (Dense(E, E, **kw) for _ in range(3))
        self.out = Dense(E, E, **kw)
        self.ln2 = LayerNorm(E, cfg)
        self.mlp_in = Dense(E, M, **kw)
        self.mlp_out = Dense(M, E, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        B, S, E = x.shape
        H = cfg.num_heads
        rate = cfg.dropout if train else 0.0
        h = self.ln1(x)
        q, k, v = (p(h).view(B, S, H, E // H) for p in (self.q, self.k,
                                                         self.v))
        attn = flash_attention(q, k, v, causal=False).reshape(B, S, E)
        x = x + dropout(self.out(attn), rate, generator)
        h = self.ln2(x)
        h = bias_gelu(self.mlp_in.product(h),
                      self.mlp_in.bias.to(cfg.dtype))
        return x + dropout(self.mlp_out(h), rate, generator)


class ViT(nn.Module):
    """images [B, H, W, 3] -> logits [B, num_classes] f32. Parameters are
    created uninitialised in ``param_dtype`` on the current default
    device; :meth:`init_weights` fills them, or a state dict is loaded."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        E, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = Conv(3, E, (p, p), p, 0, dtype=cfg.dtype,
                                param_dtype=cfg.param_dtype, bias=True)
        self.cls = nn.Parameter(torch.empty(1, 1, E, dtype=cfg.param_dtype))
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.num_patches + 1, E, dtype=cfg.param_dtype))
        self.blocks = []
        for i in range(cfg.num_layers):
            block = EncoderBlock(cfg)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_final = LayerNorm(E, cfg)
        self.head = Dense(E, cfg.num_classes, dtype=cfg.dtype,
                          param_dtype=cfg.param_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initialisers: xavier_uniform kernels (the patch
        embedding's over its [p, p, 3, E] kernel), zero biases, the cls
        token zeros, pos_embed N(0, 0.02), LayerNorm scale 1 and bias 0,
        the head zeros. In place, from ``generator`` (the numbers differ
        from JAX's)."""
        self.patch_embed.init_variance_scaling(1.0, "fan_avg", generator,
                                               "uniform")
        self.cls.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for block in self.blocks:
            for m in (block.q, block.k, block.v, block.out, block.mlp_in,
                      block.mlp_out):
                m.init_xavier_uniform(generator)
            block.ln1.reset()
            block.ln2.reset()
        self.ln_final.reset()
        self.head.init_zeros()

    def forward(self, images: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(images.to(cfg.dtype)).reshape(B, -1,
                                                           cfg.embed_dim)
        cls = self.cls.to(cfg.dtype).expand(B, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for block in self.blocks:
            x = block(x, train, generator)
        x = self.ln_final(x)
        return self.head(x[:, 0]).float()


def layer_norm_calls(cfg: ViTConfig) -> int:
    """K20 calls a forward pass makes (and a backward pass): two a layer and
    the final norm (ViT-B/16: 25)."""
    return 2 * cfg.num_layers + 1

"""Llama-family decoder-only transformer, the port of kubeflow_tpu.models.llama.

Each layer runs RMSNorm -> q/k/v projections -> RoPE -> attention ->
o_proj -> RMSNorm -> SwiGLU MLP, with the JAX package's rounding points:
parameters are cast to the activation dtype at each product, norms and
RoPE compute in f32 and cast back, residual adds stay in the activation
dtype, attention logits are f32, and the logits come out f32
(``logits_f32``).

Three forward modes (``Llama.forward``):

- no cache (the training layout, forward only here): causal attention
  through ``flash_attention`` (``attn_impl="flash"``) or the plain
  ``mha_reference`` (``attn_impl="full"``);
- ``decode="prefill"``: fresh cache rows; k/v are written to the cache
  and attention runs causally over the incoming tokens through the flash
  kernel;
- ``decode=True``: one or more tokens per row against a dense cache with
  a per-row ``cache_index``, through ``mha_reference`` with a mask.

The KV cache is explicit state: a list with one dict per layer holding
``cached_key`` / ``cached_value`` [B, max_len, Hkv, D] and
``cache_index`` [B] int32 (see :meth:`Llama.init_cache`). Cache tensors
are written IN PLACE (a functional update would copy the whole cache
every decode step) and the list is returned.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.ops.attention import mha_reference
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.rope import apply_rope, rope_frequencies

LayerCache = Dict[str, torch.Tensor]
DtypeLike = Union[str, torch.dtype]


def as_dtype(d: DtypeLike) -> torch.dtype:
    """torch dtype from a torch dtype or a name ("bfloat16", "float32")."""
    if isinstance(d, torch.dtype):
        return d
    dt = getattr(torch, str(d), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {d!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    embed_dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: DtypeLike = torch.bfloat16         # activations
    param_dtype: DtypeLike = torch.float32    # parameter storage
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    logits_f32: bool = True
    # Options of the JAX model that later slices port; setting one raises
    # NotImplementedError when the model is built.
    fused_qkv: bool = False
    fused_gate_up: bool = False
    kv_cache_dtype: str = ""
    decode_staging: int = 0
    paged_kv_blocks: int = 0
    pipeline_stages: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(
            vocab_size=128256, embed_dim=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, mlp_dim=14336, rope_theta=500000.0,
            **kw,
        )

    @classmethod
    def llama3_70b(cls, **kw) -> "LlamaConfig":
        return cls(
            vocab_size=128256, embed_dim=8192, num_layers=80, num_heads=64,
            num_kv_heads=8, head_dim=128, mlp_dim=28672, rope_theta=500000.0,
            **kw,
        )

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test config: real architecture, toy widths."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("embed_dim", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("mlp_dim", 128)
        kw.setdefault("max_seq_len", 128)
        return cls(**kw)


#: Config options whose JAX code paths are later slices of the port.
_LATER_SLICES = {
    "fused_qkv": "training",
    "fused_gate_up": "training",
    "kv_cache_dtype": "int8 serving",
    "decode_staging": "staged serving",
    "paged_kv_blocks": "paged serving",
}


def _check_supported(cfg: LlamaConfig) -> None:
    for name, slice_ in _LATER_SLICES.items():
        if getattr(cfg, name):
            raise NotImplementedError(
                f"LlamaConfig.{name}={getattr(cfg, name)!r} is not ported "
                f"yet (the {slice_} slice); leave it unset")
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "LlamaConfig.pipeline_stages > 1 is not ported yet (the "
            "multi-GPU slice)")


class Dense(nn.Module):
    """Bias-free projection ``x @ W.T`` with W [out, in] stored in
    ``param_dtype`` and cast to the activation dtype at the product (the
    flax DenseGeneral rounding point)."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: LlamaConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.weight = nn.Parameter(torch.ones(cfg.embed_dim,
                                              dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, eps=self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        H, Hkv, Dh, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.embed_dim)
        self.q_proj = Dense(E, H * Dh, cfg)
        self.k_proj = Dense(E, Hkv * Dh, cfg)
        self.v_proj = Dense(E, Hkv * Dh, cfg)
        self.o_proj = Dense(H * Dh, E, cfg)

    def forward(self, x, positions, cos, sin, *,
                cache: Optional[LayerCache] = None,
                decode: Union[bool, str] = False,
                attn_impl: str = "flash") -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(B, S, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        if decode:
            out = self._decode_attention(q, k, v, cache, mode=decode)
        elif attn_impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        elif attn_impl == "full":
            out = mha_reference(q, k, v, causal=True)
        else:
            raise ValueError(f"attn_impl {attn_impl!r} (flash or full)")
        return self.o_proj(out.reshape(B, S, cfg.num_heads * cfg.head_dim))

    def _decode_attention(self, q, k, v, cache: LayerCache, mode):
        """Write k/v at each row's ``cache_index`` and attend.

        ``mode == "prefill"``: the rows are fresh (index 0), so attention
        runs causally over the incoming tokens through the flash kernel
        and reads the live k/v, not the cache. ``mode is True``: attend
        the whole cache with a per-row causal mask (the not-yet-written
        tail is masked too).

        The write start is CLAMPED to ``max_len - S_new``, as JAX's
        dynamic_update_slice clamps it: idle batch slots decode every
        step, so their index grows without bound, and an unclamped index
        on a CUDA tensor is a device-side assert. Active rows never reach
        the clamp (the engine retires them at max_len - 1)."""
        ck, cv, idx = (cache["cached_key"], cache["cached_value"],
                       cache["cache_index"])
        B, S_new = q.shape[:2]
        L = ck.shape[1]
        steps = torch.arange(S_new, device=q.device)
        start = idx.long().clamp(0, max(L - S_new, 0))
        rows = start[:, None] + steps[None, :]                 # [B, S_new]
        batch = torch.arange(B, device=q.device)[:, None]
        ck[batch, rows] = k.to(ck.dtype)
        cv[batch, rows] = v.to(cv.dtype)
        cache["cache_index"] = idx + S_new
        if mode == "prefill":
            return flash_attention(q, k, v, causal=True)
        q_pos = idx.long()[:, None] + steps[None, :]            # [B, S]
        kv_pos = torch.arange(L, device=q.device)
        mask = kv_pos[None, None, :] <= q_pos[:, :, None]        # [B, S, L]
        return mha_reference(q, ck, cv, mask=mask[:, None])


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = Dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.up_proj = Dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.down_proj = Dense(cfg.mlp_dim, cfg.embed_dim, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg)
        self.attn = Attention(cfg)
        self.post_attn_norm = RMSNorm(cfg)
        self.mlp = Mlp(cfg)

    def forward(self, x, positions, cos, sin, *, cache=None, decode=False,
                attn_impl="flash") -> torch.Tensor:
        h = self.attn(self.input_norm(x), positions, cos, sin, cache=cache,
                      decode=decode, attn_impl=attn_impl)
        x = x + h
        return x + self.mlp(self.post_attn_norm(x))


class Llama(nn.Module):
    """Decoder-only LM. Parameters are created uninitialised in
    ``param_dtype`` on the current default device; :meth:`init_weights`
    fills them from a generator, or a state dict is loaded."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.embed_dim,
                                              dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg)
        self.lm_head = (None if cfg.tie_embeddings
                        else Dense(cfg.embed_dim, cfg.vocab_size, cfg))
        self._rope: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initialisers: N(0, 0.02) for projections and the
        embedding, ones for the norms. In place, in each parameter's own
        dtype and device (an 8B model initialises on the card in bf16)."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def rope_tables(self, device: torch.device):
        """(cos, sin) [max_seq_len, head_dim // 2] f32 on ``device``."""
        if device not in self._rope:
            self._rope[device] = rope_frequencies(
                self.cfg.head_dim, self.cfg.max_seq_len,
                theta=self.cfg.rope_theta, device=device)
        return self._rope[device]

    def init_cache(self, batch: int, max_len: int, *,
                   device=None) -> List[LayerCache]:
        """Zeroed dense decode cache: per layer, k/v [batch, max_len,
        Hkv, D] in the activation dtype and cache_index [batch] int32."""
        cfg = self.cfg
        device = self.embed.device if device is None else device
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return [{
            "cached_key": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "cached_value": torch.zeros(shape, dtype=cfg.dtype,
                                        device=device),
            "cache_index": torch.zeros(batch, dtype=torch.int32,
                                       device=device),
        } for _ in range(cfg.num_layers)]

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[List[LayerCache]] = None,
        decode: Union[bool, str] = False,
        return_hidden: bool = False,
        attn_impl: str = "flash",
    ):
        """tokens [B, S] -> logits [B, S, V] (or the final hidden state
        [B, S, E] with ``return_hidden``). With ``decode`` (True or
        "prefill") the cache is required and ``(out, cache)`` returns."""
        cfg = self.cfg
        B, S = tokens.shape
        if decode and cache is None:
            raise ValueError("decode mode needs a cache (Llama.init_cache)")
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        cos, sin = self.rope_tables(tokens.device)
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, cos, sin,
                      cache=cache[i] if decode else None, decode=decode,
                      attn_impl=attn_impl)
        x = self.final_norm(x)
        out = x if return_hidden else self.head_logits(x)
        return (out, cache) if decode else out

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits tail (lm_head or tied embedding, then softcap) on a
        hidden state [B, S, E]. Serving runs it on one position per row:
        at 128k vocab the full prefill logits would be GBs."""
        cfg = self.cfg
        x = x.to(cfg.dtype)
        out_dtype = torch.float32 if cfg.logits_f32 else cfg.dtype
        if cfg.tie_embeddings:
            # f32 accumulation, as the JAX einsum's preferred_element_type.
            logits = F.linear(x.float(), self.embed.to(cfg.dtype).float())
        else:
            logits = self.lm_head(x)
        logits = logits.to(out_dtype)
        if cfg.logits_softcap > 0:
            logits = torch.tanh(logits / cfg.logits_softcap) \
                * cfg.logits_softcap
        return logits

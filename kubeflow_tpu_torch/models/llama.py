"""Llama-family decoder-only transformer, the port of kubeflow_tpu.models.llama.

Each layer runs RMSNorm -> q/k/v projections -> RoPE -> attention ->
o_proj -> residual add + RMSNorm -> SwiGLU MLP -> residual add, with the
JAX package's rounding points: parameters are cast to the activation dtype
at each product, norms and RoPE compute in f32 and cast back, residual
adds stay in the activation dtype, attention logits are f32, and the
logits come out f32 (``logits_f32``). The element-wise work runs in the
port's kernels on the card: RMSNorm (K6), RoPE (K7, reading a fused
q/k/v projection in place), SwiGLU (K9, reading a fused gate/up
projection in place) and the residual add fused with the norm that reads
it (K10): within a layer always, and from one layer into the next layer's
input norm (or the final norm) wherever no checkpoint boundary lies
between them (every path but the remat policies').

Three forward modes (``Llama.forward``):

- no cache (the training layout, differentiable): causal attention
  through ``flash_attention`` (``attn_impl="flash"``: K1 forward, K2
  backward on the card) or the plain ``mha_reference``
  (``attn_impl="full"``). With ``remat`` and grad enabled each layer runs
  as ``torch.utils.checkpoint`` segments that save what ``remat_policy``
  names (``DecoderLayer.forward_remat``);
- ``decode="prefill"``: fresh cache rows; k/v are written to the cache
  and attention runs causally over the incoming tokens through the flash
  kernel;
- ``decode=True``: one or more tokens per row against a dense cache with
  a per-row ``cache_index``. One token per row goes through
  ``ops/decode_attention.py`` (the decode-attention kernel on the card);
  several (a chunked-prefill extend) through the flash kernel over the
  row's cache on the card, and through the masked plain attention on the
  CPU. With ``stage_step`` (``decode_staging > 0``) the step writes its
  k/v into the chunk's staging rows instead of the cache, and the
  serving engine flushes them once per chunk: RoPE's staged mode (K7)
  writes them in its own launch.

With ``paged_kv_blocks`` = P > 0 the cache is the physically paged pool
of ``ops/paged_attention.py`` (``Attention._paged_decode_attention``):
one [P + 1, paged_kv_block_size, Hkv, D] pool per layer shared by every
slot, addressed through the ``block_tables`` the caller passes.

The KV cache is explicit state: a list with one dict per layer holding
``cached_key`` / ``cached_value`` [B, max_len, Hkv, D] (int8 with f32
``key_scale`` / ``value_scale`` [B, max_len, Hkv, 1] when
``kv_cache_dtype == "int8"``; pools [P + 1, bs, Hkv, .] when paged),
``stage_key`` / ``stage_value``
[B, decode_staging, Hkv, D] when staging, and ``cache_index`` [B] int32
(see :meth:`Llama.init_cache`). Every cache tensor, ``cache_index``
included, is written IN PLACE (a functional update would copy the whole
cache every decode step, and a captured CUDA graph keeps the buffers it
was captured with) and the list is returned.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.ops.attention import mha_reference
from kubeflow_tpu_torch.ops.decode_attention import decode_attention
from kubeflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_lse,
)
from kubeflow_tpu_torch.ops.int8_linear import (
    DECODE_MAX_ROWS,
    dequantize_int8,
    int8_linear,
    int8_linear_group,
    int8_linear_swiglu,
)
from kubeflow_tpu_torch.ops.norms import add_rms_norm, rms_norm
from kubeflow_tpu_torch.ops.paged_attention import (
    gather_cache,
    physical_rows,
    pool_shape,
    scatter_kv_rows,
)
from kubeflow_tpu_torch.ops.rope import (
    apply_rope_fused,
    apply_rope_qk,
    rope_frequencies,
    rope_stage,
    rope_stage_fused,
)
from kubeflow_tpu_torch.ops.swiglu import swiglu, swiglu_fused

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
    # Layout only: the port always runs its layers as a Python loop;
    # ``scan_layers`` says which tree ``models/convert.py`` writes for the
    # JAX package (stacked ``layers`` or ``layer_{i}``).
    scan_layers: bool = True
    # Rematerialisation in the training forward (grad enabled, no cache).
    # Each policy saves, per layer and besides the layer input, exactly the
    # tensors the JAX policy of the same name saves
    # (kubeflow_tpu/models/llama.py::_remat_policy); the backward replays
    # what it needs of the rest:
    #   "full"         - nothing: the whole layer replays;
    #   "qkv_attn"     - q/k/v (post-RoPE) and the attention output ("qkv",
    #                    "attn_out"): the norm and projections before them,
    #                    the attention forward (for its lse) and o_proj +
    #                    MLP after them replay;
    #   "qkv_attn_lse" - those and the attention's lse ("attn_resid"; its
    #                    o is the attention output): no attention replay;
    #   "minimal"      - those and gate/up ("mlp_gate", "mlp_up"): the
    #                    norms, o_proj (nothing saves the residual it
    #                    feeds), the add and SwiGLU replay; no attention, no
    #                    q/k/v or gate/up projection;
    #   "attn_only"    - the attention output: projections, attention and
    #                    MLP replay;
    #   "mlp_only"     - gate/up: the attention block replays;
    #   "dots"         - the projections' outputs the backward needs (q/k/v
    #                    before RoPE, o_proj's, gate/up; the down
    #                    projection's feeds only the residual add, whose
    #                    backward needs nothing, so neither saves it): the
    #                    norms, RoPE, attention and SwiGLU replay.
    # With the fused flags, q/k/v and gate/up are the fused products'
    # slices (or, for "dots", the fused products themselves).
    remat: bool = True
    remat_policy: str = "full"
    # Serving cache options: "int8" stores the KV cache as absmax int8
    # rows with f32 scales (quantize_kv_rows); decode_staging = C > 0
    # stages each decode chunk's k/v in [B, C, Hkv, D] rows that the
    # engine flushes into the cache once per chunk.
    kv_cache_dtype: str = ""
    decode_staging: int = 0
    # > 0: the decode cache is one physically paged pool per layer,
    # [paged_kv_blocks + 1, paged_kv_block_size, Hkv, D], block id
    # paged_kv_blocks being the scratch page (ops/paged_attention.py); the
    # caller passes block_tables (the serving engine does).
    paged_kv_blocks: int = 0
    paged_kv_block_size: int = 16
    # One [E, Hkv * (G + 2) * Dh] q/k/v projection (rows ordered kv head,
    # slot, d; G = H / Hkv; used only when H % Hkv == 0, as in the JAX
    # model) and one [E, 2 * F] gate/up projection (rows slot, f): one
    # product each instead of three and two. RoPE (K7) and SwiGLU (K9) read
    # the fused outputs in place.
    fused_qkv: bool = False
    fused_gate_up: bool = False
    # The pipeline layout is the multi-GPU slice's: > 1 raises.
    pipeline_stages: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))

    @property
    def fuses_qkv(self) -> bool:
        """Whether the model builds one q/k/v projection: ``fused_qkv``
        where the heads group evenly, as the JAX branch requires."""
        return self.fused_qkv and self.num_heads % self.num_kv_heads == 0

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
        kw.setdefault("scan_layers", False)
        kw.setdefault("remat", False)
        return cls(**kw)


@dataclasses.dataclass
class Paging:
    """What a forward over a paged cache needs besides the cache: the
    block tables, and which positions it writes."""
    tables: torch.Tensor                       # [B, max_blocks] int32
    # [B]: positions at or past write_lens[b] are not written (prefill pad
    # columns); positions below write_from[b] are not written (a shared
    # prefix whose pages already hold them).
    write_lens: Optional[torch.Tensor] = None
    write_from: Optional[torch.Tensor] = None


#: remat_policy names of the JAX package (models/llama.py::_remat_policy).
REMAT_POLICIES = ("full", "minimal", "qkv_attn", "qkv_attn_lse",
                  "attn_only", "mlp_only", "dots")
KV_CACHE_DTYPES = ("", "int8")


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} (one of "
                         f"{KV_CACHE_DTYPES})")
    if cfg.decode_staging < 0:
        raise ValueError(f"decode_staging {cfg.decode_staging} must be >= 0")
    if cfg.paged_kv_blocks < 0 or cfg.paged_kv_block_size < 1:
        raise ValueError(f"paged_kv_blocks {cfg.paged_kv_blocks} must be >= 0 "
                         f"and paged_kv_block_size "
                         f"{cfg.paged_kv_block_size} >= 1")
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "LlamaConfig.pipeline_stages > 1 is not ported yet (the "
            "multi-GPU slice)")
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (one "
                         f"of {', '.join(REMAT_POLICIES)})")


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


class Int8Dense(nn.Module):
    """Inference-only projection with int8 weights, which the serving engine
    swaps in for a :class:`Dense` (``ServingConfig.quantize="int8"``). It
    holds ``weight`` int8 [out, in] and ``scale`` bf16 [out, S] as buffers;
    the weight it applies is ``weight[n, k] * scale[n, k mod S]`` rounded
    once to the activation dtype (S is 1, or head_dim for ``o_proj``), as
    the JAX engine's jitted steps apply ``_materialize``'s kernels. The
    product runs through :func:`~kubeflow_tpu_torch.ops.int8_linear.
    int8_linear` (K4 on the card). It has no gradient."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 cfg: LlamaConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x.to(self.dtype), self.weight, self.scale,
                           out_dtype=self.dtype)

    def dequantized(self) -> torch.Tensor:
        """The plain weight [out, in] in the activation dtype."""
        return dequantize_int8(self.weight, self.scale, self.dtype)


def int8_group(*projections: nn.Module) -> bool:
    """Whether ``projections`` of the same input run as one grouped int8
    product: all :class:`Int8Dense`, of one activation dtype, their scales
    all per row (S = 1) or all per column. Which projections were
    quantized decides it (``ServingConfig.quantize_min_size`` can leave some
    :class:`Dense`); otherwise each runs on its own."""
    return (all(isinstance(p, Int8Dense) for p in projections)
            and len({p.dtype for p in projections}) == 1
            and len({p.scale.shape[1] == 1 for p in projections}) == 1)


def grouped_int8_products(x: torch.Tensor, *projections: Int8Dense):
    """The outputs of ``projections`` (see :func:`int8_group`) on ``x``,
    from one :func:`int8_linear_group` call (one K4 launch on the card)."""
    dtype = projections[0].dtype
    return int8_linear_group(x.to(dtype),
                             [(p.weight, p.scale) for p in projections],
                             out_dtype=dtype)


def int8_launches_per_pass(model: nn.Module) -> int:
    """K4 launches in one forward pass of ``model``: a grouped or fused
    product counts once (q/k/v, gate/up), any other :class:`Int8Dense` once
    (o, down, lm_head). With every projection int8, 4 a layer and the
    lm_head."""
    n = 0
    for m in model.modules():
        if isinstance(m, (Attention, Mlp)):
            group = m.input_projections()
            n += 1 if int8_group(*group) else sum(
                isinstance(p, Int8Dense) for p in group)
            n += isinstance(m.o_proj if isinstance(m, Attention)
                            else m.down_proj, Int8Dense)
    return n + isinstance(getattr(model, "lm_head", None), Int8Dense)


def dequantized_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with each :class:`Int8Dense` as the
    :class:`Dense` it stands for (its dequantized weight, no scale): it
    loads into a model built from the same config."""
    sd = model.state_dict()
    for name, m in model.named_modules():
        if isinstance(m, Int8Dense):
            sd[f"{name}.weight"] = m.dequantized()
            del sd[f"{name}.scale"]
    return sd


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.weight = nn.Parameter(torch.ones(cfg.embed_dim,
                                              dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, eps=self.eps)

    def add(self, x: torch.Tensor, h: torch.Tensor):
        """(x + h, RMSNorm(x + h)) in one pass (K10 on the card)."""
        return add_rms_norm(x, h, self.weight, eps=self.eps)


def _products(x: torch.Tensor, *projections: nn.Module):
    """The projections of x: one grouped int8 product when they form one
    (:func:`int8_group`), else each on its own."""
    if int8_group(*projections):
        return grouped_int8_products(x, *projections)
    return [p(x) for p in projections]


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        H, Hkv, Dh, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.embed_dim)
        self.fused_qkv = cfg.fuses_qkv
        if self.fused_qkv:
            self.qkv_proj = Dense(E, Hkv * (H // Hkv + 2) * Dh, cfg)
        else:
            self.q_proj = Dense(E, H * Dh, cfg)
            self.k_proj = Dense(E, Hkv * Dh, cfg)
            self.v_proj = Dense(E, Hkv * Dh, cfg)
        self.o_proj = Dense(H * Dh, E, cfg)

    def input_projections(self) -> Tuple[nn.Module, ...]:
        return ((self.qkv_proj,) if self.fused_qkv
                else (self.q_proj, self.k_proj, self.v_proj))

    def projections(self, x) -> Tuple[torch.Tensor, ...]:
        """The products of the normed input before RoPE: (qkv [B, S, Hkv,
        G + 2, D],) with ``fused_qkv``, else (q [B, S, H, D], k, v [B, S,
        Hkv, D])."""
        cfg = self.cfg
        B, S, _ = x.shape
        Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
        if self.fused_qkv:
            return (self.qkv_proj(x).view(B, S, Hkv, -1, Dh),)
        q, k, v = _products(x, *self.input_projections())
        return (q.view(B, S, cfg.num_heads, Dh), k.view(B, S, Hkv, Dh),
                v.view(B, S, Hkv, Dh))

    @staticmethod
    def rotate(products, positions, cos, sin):
        """q, k (RoPE applied) and v of :meth:`projections`' products."""
        if len(products) == 1:
            return apply_rope_fused(products[0], cos, sin,
                                    positions=positions)
        q, k, v = products
        q, k = apply_rope_qk(q, k, cos, sin, positions=positions)
        return q, k, v

    def project(self, x, positions, cos, sin):
        """q [B, S, H, D], k and v [B, S, Hkv, D] of the normed input, with
        RoPE applied to q and k."""
        return self.rotate(self.projections(x), positions, cos, sin)

    @staticmethod
    def attend(q, k, v, attn_impl: str = "flash") -> torch.Tensor:
        """Causal attention of the training layout: [B, S, H, D]."""
        if attn_impl == "flash":
            return flash_attention(q, k, v, causal=True)
        if attn_impl == "full":
            return mha_reference(q, k, v, causal=True)
        raise ValueError(f"attn_impl {attn_impl!r} (flash or full)")

    def out_proj(self, out: torch.Tensor) -> torch.Tensor:
        B, S = out.shape[:2]
        return self.o_proj(out.reshape(B, S, -1))

    def forward(self, x, positions, cos, sin, *,
                cache: Optional[LayerCache] = None,
                decode: Union[bool, str] = False,
                attn_impl: str = "flash",
                stage_step: Optional[int] = None,
                paging: Optional[Paging] = None) -> torch.Tensor:
        if decode is True and stage_step is not None:
            out = self._staged_attention(self.projections(x), positions,
                                         cos, sin, cache, stage_step, paging)
            return self.out_proj(out)
        q, k, v = self.project(x, positions, cos, sin)
        if decode:
            out = self._decode_attention(q, k, v, cache, mode=decode,
                                         paging=paging)
        else:
            out = self.attend(q, k, v, attn_impl)
        return self.out_proj(out)

    def _by_table(self, paging: Optional[Paging]) -> dict:
        """K3's block-table arguments for a paged cache (which needs
        ``paging``), none for a dense one."""
        if self.cfg.paged_kv_blocks <= 0:
            return {}
        if paging is None:
            raise ValueError("a paged cache (LlamaConfig.paged_kv_blocks > "
                             "0) needs paging=Paging(block tables)")
        return {"block_tables": paging.tables,
                "block_size": self.cfg.paged_kv_block_size}

    def _staged_attention(self, products, positions, cos, sin,
                          cache: LayerCache, stage_step: int,
                          paging: Optional[Paging] = None):
        """A staged decode step (``stage_step``, which needs
        ``decode_staging``), as the JAX model's ``_decode_attention`` runs
        it: q and k rotated and k/v written to staging column
        ``stage_step`` of every row in one K7 launch (the staged mode, on
        :meth:`projections`' products; the fused q/k/v read in place),
        then attention over the flushed cache (``< cache_index``; dense,
        or the pool by ``paging``'s tables) and staging rows
        ``0..stage_step``. The engine's flush writes the cache and
        advances ``cache_index``."""
        if "stage_key" not in cache:
            raise ValueError("stage_step needs a staging cache "
                             "(LlamaConfig.decode_staging > 0)")
        by_table = self._by_table(paging)
        sk, sv = cache["stage_key"], cache["stage_value"]
        if len(products) == 1:
            q = rope_stage_fused(products[0], cos, sin, positions, sk, sv,
                                 stage_step)
        else:
            q = rope_stage(*products, cos, sin, positions, sk, sv,
                           stage_step)
        return decode_attention(q, cache["cached_key"],
                                cache["cached_value"], cache["cache_index"],
                                k_scale=cache.get("key_scale"),
                                v_scale=cache.get("value_scale"),
                                stage_key=sk, stage_value=sv,
                                stage_step=stage_step, **by_table)

    def _decode_attention(self, q, k, v, cache: LayerCache, mode,
                          paging: Optional[Paging] = None):
        """Write k/v and attend, as the JAX model's
        ``Attention._decode_attention`` does (a paged cache, which needs
        ``paging``, as ``_paged_decode_attention`` says; a staged step is
        :meth:`_staged_attention`'s).

        k/v are written at each row's ``cache_index`` (quantized for an
        int8 cache) and ``cache_index`` advances in place.
        ``mode == "prefill"``: the rows are fresh (index 0), so attention
        runs causally over the incoming tokens through the flash kernel
        and reads the live k/v, not the cache. ``mode is True``: attend
        the cache with a per-row causal mask (the not-yet-written tail is
        masked too).

        The write start is CLAMPED to ``max_len - S_new``, as JAX's
        dynamic_update_slice clamps it: idle batch slots decode every
        step, so their index grows without bound, and an unclamped index
        on a CUDA tensor is a device-side assert. Active rows never reach
        the clamp (the engine retires them at max_len - 1)."""
        ck, cv, idx = (cache["cached_key"], cache["cached_value"],
                       cache["cache_index"])
        ks, vs = cache.get("key_scale"), cache.get("value_scale")
        B, S_new = q.shape[:2]
        if self._by_table(paging):          # a paged cache (with paging)
            return self._paged_decode_attention(q, k, v, cache, mode, paging)
        L = ck.shape[1]
        steps = torch.arange(S_new, device=q.device)
        start = idx.long().clamp(0, max(L - S_new, 0))
        rows = start[:, None] + steps[None, :]                 # [B, S_new]
        batch = torch.arange(B, device=q.device)[:, None]
        if ks is not None:
            k8, k_s = quantize_kv_rows(k)
            v8, v_s = quantize_kv_rows(v)
            ck[batch, rows] = k8
            ks[batch, rows] = k_s
            cv[batch, rows] = v8
            vs[batch, rows] = v_s
        else:
            ck[batch, rows] = k.to(ck.dtype)
            cv[batch, rows] = v.to(cv.dtype)
        idx.add_(S_new)
        if mode == "prefill":
            return flash_attention(q, k, v, causal=True)
        if S_new == 1 or not q.is_cuda:
            return decode_attention(q, ck, cv, idx, k_scale=ks, v_scale=vs)
        return self._extend_attention(q, ck, cv, ks, vs, start)

    @staticmethod
    def _extend_attention(q, ck, cv, ks, vs, q_start):
        """Several query rows of ONE cache row on the card (a chunked-
        prefill extend): the flash kernel over the row's cache, causal
        from the device position ``q_start`` of query row 0 (rows past
        the new tokens are masked). An int8 row is first dequantized to
        a temporary in q's dtype."""
        if q.shape[0] != 1:
            raise ValueError("a multi-token decode step on the card takes "
                             f"one cache row, got {q.shape[0]}")
        if ks is not None:
            ck = (ck.float() * ks).to(q.dtype)
            cv = (cv.float() * vs).to(q.dtype)
        out, _ = flash_attention_lse(q, ck, cv, causal=True,
                                     q_offset=q_start, kv_offset=0)
        return out

    def _paged_decode_attention(self, q, k, v, cache: LayerCache, mode,
                                paging: Paging):
        """Write k/v and attend against the physically paged pool, as the
        JAX model's ``Attention._paged_decode_attention`` does (layout and
        exactness contract in ``ops/paged_attention.py``).

        ``cached_key``/``cached_value`` (and the scales) are pools shared by
        every slot; ``cache_index`` stays per row. Writes land at the rows
        ``paging.tables`` maps each position to: positions at or past
        ``paging.write_lens`` (prefill pad columns), below
        ``paging.write_from`` (a prefix another sequence's pages already
        hold) or past the table redirect to the scratch page, so no junk
        write touches a live, possibly shared, page.

        - a staged step (``_staged_attention``): the staging write is
          the dense one (staging rows are per slot, not paged), and K3
          reads the pool by table;
        - ``mode == "prefill"``: attention over the live k/v (flash);
        - one query row: K3 by table (the plain version on the CPU);
        - several query rows of one slot on the card (a chunked-prefill
          extend): the slot's pages gathered into dense order (dequantized
          for an int8 pool), then the flash kernel from the device
          position of query row 0, as ``_extend_attention`` runs it."""
        cfg = self.cfg
        bs = cfg.paged_kv_block_size
        tables = paging.tables
        ck, cv, idx = (cache["cached_key"], cache["cached_value"],
                       cache["cache_index"])
        ks, vs = cache.get("key_scale"), cache.get("value_scale")
        S_new = q.shape[1]
        start = idx.long()
        positions = start[:, None] + torch.arange(S_new, device=q.device)
        valid = None
        if paging.write_lens is not None:
            valid = positions < paging.write_lens.long()[:, None]
        if paging.write_from is not None:
            keep = positions >= paging.write_from.long()[:, None]
            valid = keep if valid is None else valid & keep
        rows = physical_rows(tables, positions, bs,
                             num_blocks=cfg.paged_kv_blocks, valid=valid)
        if ks is not None:
            k8, k_s = quantize_kv_rows(k)
            v8, v_s = quantize_kv_rows(v)
            scatter_kv_rows(ck, rows, k8)
            scatter_kv_rows(ks, rows, k_s)
            scatter_kv_rows(cv, rows, v8)
            scatter_kv_rows(vs, rows, v_s)
        else:
            scatter_kv_rows(ck, rows, k)
            scatter_kv_rows(cv, rows, v)
        idx.add_(S_new)
        if mode == "prefill":
            return flash_attention(q, k, v, causal=True)
        if S_new == 1 or not q.is_cuda:
            return decode_attention(q, ck, cv, idx, k_scale=ks, v_scale=vs,
                                    block_tables=tables, block_size=bs)
        ck, cv, ks, vs = gather_cache(tables, bs, ck, cv, ks, vs)
        return self._extend_attention(q, ck, cv, ks, vs, start)


def quantize_kv_rows(x: torch.Tensor):
    """Absmax int8 per (.., position, kv-head) row: (int8 rows, f32 scales
    [..., 1]), scale = max(max|x| / 127, 1e-8), rows rounded half to
    even. The cache write and the engine's staged flush share it, as in
    the JAX model."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(xf / s).to(torch.int8), s


class Mlp(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.fused_gate_up = cfg.fused_gate_up
        if self.fused_gate_up:
            self.gate_up_proj = Dense(cfg.embed_dim, 2 * cfg.mlp_dim, cfg)
        else:
            self.gate_proj = Dense(cfg.embed_dim, cfg.mlp_dim, cfg)
            self.up_proj = Dense(cfg.embed_dim, cfg.mlp_dim, cfg)
        self.down_proj = Dense(cfg.mlp_dim, cfg.embed_dim, cfg)

    def input_projections(self) -> Tuple[nn.Module, ...]:
        return ((self.gate_up_proj,) if self.fused_gate_up
                else (self.gate_proj, self.up_proj))

    def products(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(gu [..., 2, F],) with ``fused_gate_up``, else (gate, up)."""
        if self.fused_gate_up:
            return (self.gate_up_proj(x).unflatten(-1, (2, -1)),)
        return tuple(_products(x, *self.input_projections()))

    def reduce(self, *products: torch.Tensor) -> torch.Tensor:
        """down(silu(gate) * up) of :meth:`products`' products (K9)."""
        h = (swiglu_fused(products[0]) if len(products) == 1
             else swiglu(*products))
        return self.down_proj(h)

    def epilogue_weights(self, x: torch.Tensor):
        """The ``((q, scale), (q, scale))`` of gate and up when K4 writes
        ``silu(gate) * up`` itself (:func:`int8_linear_swiglu`): int8
        gate/up weights that form one group (:func:`int8_group`) with
        per-row scales, at a decode step's rows (at most
        :data:`DECODE_MAX_ROWS`: K4's decode kernel). Else None: more rows
        (the paged step's 48 slots, prefill, extend) or bf16 weights take
        :meth:`products` and K9's own launch."""
        projections = self.input_projections()
        if not int8_group(*projections) \
                or projections[0].scale.shape[1] != 1 \
                or x.numel() // x.shape[-1] > DECODE_MAX_ROWS:
            return None
        if self.fused_gate_up:
            w, s = self.gate_up_proj.weight, self.gate_up_proj.scale
            F = w.shape[0] // 2
            return (w[:F], s[:F]), (w[F:], s[F:])
        return tuple((p.weight, p.scale) for p in projections)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = self.epilogue_weights(x)
        if weights is None:
            return self.reduce(*self.products(x))
        dtype = self.input_projections()[0].dtype
        return self.down_proj(int8_linear_swiglu(x.to(dtype), *weights,
                                                 out_dtype=dtype))


class DecoderLayer(nn.Module):
    #: The feed-forward block (Mixtral's layer swaps in its expert bank).
    MLP_CLS = Mlp

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(cfg)
        self.attn = Attention(cfg)
        self.post_attn_norm = RMSNorm(cfg)
        self.mlp = type(self).MLP_CLS(cfg)

    def forward(self, x, positions, cos, sin, *, attn_impl="flash"):
        """The layer on its input x: x + attention + MLP."""
        r, d = self.residuals(x, self.input_norm(x), positions, cos, sin,
                              attn_impl=attn_impl)
        return r + d

    def residuals(self, x, normed, positions, cos, sin, *, cache=None,
                  decode=False, attn_impl="flash", stage_step=None,
                  paging=None):
        """(r, d) of the input x and its norm: r = x + attention (the add
        fused with the post-attention norm, K10) and d the MLP's output.
        The layer's output is r + d, which the caller fuses with the norm
        that reads it (the next layer's input norm, or the final one)."""
        h = self.attn(normed, positions, cos, sin, cache=cache,
                      decode=decode, attn_impl=attn_impl,
                      stage_step=stage_step, paging=paging)
        r, n = self.post_attn_norm.add(x, h)
        return r, self.mlp(n)

    # The segments of the remat policies (forward_remat).

    def _qkv(self, x, positions, cos, sin):
        return self.attn.project(self.input_norm(x), positions, cos, sin)

    def _products(self, x):
        return self.attn.projections(self.input_norm(x))

    def _attention_out(self, x, positions, cos, sin, attn_impl):
        return self.attn.attend(*self._qkv(x, positions, cos, sin),
                                attn_impl)

    def _attention_of(self, positions, cos, sin, attn_impl, *products):
        q, k, v = self.attn.rotate(products, positions, cos, sin)
        return self.attn.out_proj(self.attn.attend(q, k, v, attn_impl))

    def _mlp_inputs(self, x, h):
        r, n = self.post_attn_norm.add(x, h)
        return (r, *self.mlp.products(n))

    def _mlp_inputs_of_out(self, x, out):
        return self._mlp_inputs(x, self.attn.out_proj(out))

    def _mlp_inputs_of_x(self, x, positions, cos, sin, attn_impl):
        h = self.attn(self.input_norm(x), positions, cos, sin,
                      attn_impl=attn_impl)
        return self._mlp_inputs(x, h)

    def _post_attention(self, x, out):
        r, *products = self._mlp_inputs_of_out(x, out)
        return r + self.mlp.reduce(*products)

    def forward_remat(self, x, positions, cos, sin, policy: str, *,
                      attn_impl="flash") -> torch.Tensor:
        """The training forward under remat ``policy``
        (``LlamaConfig.remat_policy``): checkpointed segments whose inputs,
        with what the autograd Functions between them save (K1 q, k, v, o
        and lse; K7 only its tables and positions), are the layer input
        and the policy's saved tensors and nothing else. Each segment
        replays in the backward up to its last saved tensor: a projection
        that ends a segment does not run again."""
        rope = (positions, cos, sin)
        if policy == "full":
            return _ckpt(self, x, *rope, attn_impl=attn_impl)
        if policy in ("qkv_attn", "qkv_attn_lse", "attn_only"):
            if policy == "attn_only":
                out = _ckpt(self._attention_out, x, *rope, attn_impl)
            else:
                q, k, v = _ckpt(self._qkv, x, *rope)
                out = (_ckpt(self.attn.attend, q, k, v, attn_impl)
                       if policy == "qkv_attn"
                       else self.attn.attend(q, k, v, attn_impl))
            return _ckpt(self._post_attention, x, out)
        if policy == "minimal":
            products = _ckpt(self._products, x)
            q, k, v = self.attn.rotate(products, *rope)
            out = self.attn.attend(q, k, v, attn_impl)
            r, *mlp_in = _ckpt(self._mlp_inputs_of_out, x, out)
        elif policy == "mlp_only":
            r, *mlp_in = _ckpt(self._mlp_inputs_of_x, x, *rope, attn_impl)
        elif policy == "dots":
            products = _ckpt(self._products, x)
            h = _ckpt(self._attention_of, *rope, attn_impl, *products)
            r, *mlp_in = _ckpt(self._mlp_inputs, x, h)
        else:
            raise ValueError(f"unknown remat_policy {policy!r}")
        return r + _ckpt(self.mlp.reduce, *mlp_in)


def _ckpt(fn, *args, **kwargs):
    # The layers draw no random numbers, so no RNG state is kept.
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


class Llama(nn.Module):
    """Decoder-only LM. Parameters are created uninitialised in
    ``param_dtype`` on the current default device; :meth:`init_weights`
    fills them from a generator, or a state dict is loaded. ``LAYER_CLS``
    is the layer a subclass swaps (the JAX ``Llama``'s hook; Mixtral).
    ``TRAINING_UNPORTED`` and ``INT8_UNPORTED`` say why the trainer, or
    the serving engine's int8 weights, refuse a subclass (None: they take
    it)."""

    LAYER_CLS = DecoderLayer
    TRAINING_UNPORTED: Optional[str] = None
    INT8_UNPORTED: Optional[str] = None

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.embed_dim,
                                              dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(type(self).LAYER_CLS(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg)
        self.lm_head = (None if cfg.tie_embeddings
                        else Dense(cfg.embed_dim, cfg.vocab_size, cfg))
        self._rope: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initialisers: N(0, 0.02) for projections (experts
        included) and the embedding, ones for the norms. In place, in each
        parameter's own dtype and device (an 8B model initialises on the
        card in bf16)."""
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
        """Zeroed dense decode cache, per layer: k/v [batch, max_len, Hkv,
        D] in the activation dtype, or int8 with f32 ``key_scale`` /
        ``value_scale`` [batch, max_len, Hkv, 1] (``kv_cache_dtype ==
        "int8"``); ``stage_key`` / ``stage_value`` [batch,
        decode_staging, Hkv, D] in the activation dtype when staging (an
        int8 cache quantizes at the flush); cache_index [batch] int32.
        Paged (``paged_kv_blocks`` = P > 0): k/v and the scales are pools
        ``pool_shape(P, paged_kv_block_size, Hkv, D)`` whatever ``batch``
        and ``max_len``; staging rows and cache_index stay per row."""
        cfg = self.cfg
        device = self.embed.device if device is None else device
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        if cfg.paged_kv_blocks > 0:
            shape = pool_shape(cfg.paged_kv_blocks, cfg.paged_kv_block_size,
                               cfg.num_kv_heads, cfg.head_dim)
        quant = cfg.kv_cache_dtype == "int8"

        def zeros(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=device)

        caches = []
        for _ in range(cfg.num_layers):
            layer = {
                "cached_key": zeros(shape, torch.int8 if quant else cfg.dtype),
                "cached_value": zeros(shape,
                                      torch.int8 if quant else cfg.dtype),
                "cache_index": zeros(batch, torch.int32),
            }
            if quant:
                layer["key_scale"] = zeros(shape[:3] + (1,), torch.float32)
                layer["value_scale"] = zeros(shape[:3] + (1,), torch.float32)
            if cfg.decode_staging > 0:
                stage = (batch, cfg.decode_staging, cfg.num_kv_heads,
                         cfg.head_dim)
                layer["stage_key"] = zeros(stage, cfg.dtype)
                layer["stage_value"] = zeros(stage, cfg.dtype)
            caches.append(layer)
        return caches

    def forward(
        self,
        tokens: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        cache: Optional[List[LayerCache]] = None,
        decode: Union[bool, str] = False,
        return_hidden: bool = False,
        attn_impl: str = "flash",
        stage_step: Optional[int] = None,
        paging: Optional[Paging] = None,
    ):
        """tokens [B, S] -> logits [B, S, V] (or the final hidden state
        [B, S, E] with ``return_hidden``). With ``decode`` (True or
        "prefill") the cache is required and ``(out, cache)`` returns;
        ``stage_step`` makes a decode step a staged one (see
        ``Attention._staged_attention``); a paged cache needs ``paging``
        (see ``Attention._paged_decode_attention``)."""
        cfg = self.cfg
        B, S = tokens.shape
        if decode and cache is None:
            raise ValueError("decode mode needs a cache (Llama.init_cache)")
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        cos, sin = self.rope_tables(tokens.device)
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        if cfg.remat and not decode and torch.is_grad_enabled():
            for layer in self.layers:
                x = layer.forward_remat(x, positions, cos, sin,
                                        cfg.remat_policy,
                                        attn_impl=attn_impl)
            x = self.final_norm(x)
        else:
            # Each layer's closing add is fused with the norm that reads
            # it (K10): the next layer's input norm, or the final one.
            norms = [layer.input_norm for layer in self.layers[1:]]
            normed = (self.layers[0].input_norm if self.layers
                      else self.final_norm)(x)
            for i, (layer, norm) in enumerate(zip(
                    self.layers, norms + [self.final_norm])):
                r, d = layer.residuals(
                    x, normed, positions, cos, sin,
                    cache=cache[i] if decode else None, decode=decode,
                    attn_impl=attn_impl, stage_step=stage_step,
                    paging=paging)
                x, normed = norm.add(r, d)
            x = normed
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

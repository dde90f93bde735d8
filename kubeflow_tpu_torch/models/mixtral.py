"""Mixtral-style MoE transformer, the port of kubeflow_tpu.models.mixtral.

The Llama decoder with its MLP replaced by a bank of SwiGLU experts
behind a top-2 router (``parallel/moe.py``): the router is a
:class:`~kubeflow_tpu_torch.models.llama.Dense` [E, M] whose product, in
the activation dtype, the routing widens to f32; the experts hold the expert axis
first (``w_gate``, ``w_up`` [E, M, F], ``w_down`` [E, F, M], the JAX
layout), and run as batched products over the expert buffers with f32
accumulation rounded to the activation dtype (``torch.bmm``, as the JAX
package leaves its einsums to XLA), ``silu(gate) * up`` through K9. The
dispatch is the index dispatch of ``ops/moe.py`` (K12-K14 on the card;
the layer's closing add + RMSNorm takes the combine's inputs instead,
``ops/moe.py::combine_add_rms_norm``: K10's combine mode up to ROWS_MAX
rows, in K14's place).

With the serving engine's int8 weights (``ServingConfig.quantize="int8"``)
each expert leaf becomes an :class:`Int8Experts` (one bf16 scale an
element, shared by the experts, as the JAX engine quantizes the leaf over
its expert axis) whose product runs through
:func:`~kubeflow_tpu_torch.ops.int8_experts.int8_experts` (K15 on the
card); the attention projections and the lm_head become ``Int8Dense`` (K4),
as on Llama; the router [E, M] stays bf16 below ``quantize_min_size``.

Serving only, in this slice: the remat policies and the trainer raise
NotImplementedError on a Mixtral model (their aux-loss term, jitter and
the kernels' backward are the Mixtral training slice, ROADMAP Queue 1
item 6c).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from kubeflow_tpu_torch.models.llama import (
    DecoderLayer,
    Dense,
    Llama,
    LlamaConfig,
)
from kubeflow_tpu_torch.ops.int8_experts import int8_experts
from kubeflow_tpu_torch.ops.moe import combine_add_rms_norm
from kubeflow_tpu_torch.ops.swiglu import swiglu
from kubeflow_tpu_torch.parallel.moe import Top2GateConfig, moe_dispatch


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.02
    # parallel.moe dispatch mechanism ("auto" and "gather": the index
    # dispatch; "einsum" raises).
    moe_dispatch: str = "auto"

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        """The published config; ``kw`` sets the other fields and may
        override these (a cut ``num_layers``)."""
        published = dict(
            vocab_size=32000, embed_dim=4096, num_layers=32, num_heads=32,
            num_kv_heads=8, head_dim=128, mlp_dim=14336, rope_theta=1e6,
            num_experts=8)
        return cls(**{**published, **kw})

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        kw.setdefault("num_experts", 4)
        kw.setdefault("capacity_factor", 2.0)
        base = LlamaConfig.tiny()
        for f in dataclasses.fields(LlamaConfig):
            kw.setdefault(f.name, getattr(base, f.name))
        return cls(**kw)


#: The expert leaves of :class:`MoeMlp`, in the JAX layout [E, K, N].
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


class Int8Experts(nn.Module):
    """Inference-only expert leaf with int8 weights, which the serving
    engine swaps in for a :class:`MoeMlp` leaf [E, K, N]
    (``ServingConfig.quantize="int8"``). It holds ``weight`` int8 [E, N, K]
    and ``scale`` bf16 [1, N, K] as buffers: the JAX engine's int8 leaf and
    its scales [1, K, N], transposed so that K is contiguous. The weight it
    applies is ``weight * scale`` rounded once to the activation dtype, as
    the JAX engine's jitted steps apply ``_materialize``'s leaves; the
    product runs through :func:`~kubeflow_tpu_torch.ops.int8_experts.
    int8_experts` (K15 on the card). It has no gradient."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 cfg: LlamaConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [E, R, K] -> [E, R, N]."""
        return int8_experts(x.to(self.dtype), self.weight, self.scale,
                            out_dtype=self.dtype)


def _expert_product(x: torch.Tensor, w) -> torch.Tensor:
    """x [E, C, K] times an expert leaf: an :class:`Int8Experts`, or a
    bf16 parameter [E, K, N] through ``torch.bmm``."""
    if isinstance(w, Int8Experts):
        return w(x)
    return torch.bmm(x, w.to(x.dtype))


def expert_launches_per_pass(model: nn.Module) -> int:
    """K15 launches in one forward pass of ``model``: one an
    :class:`Int8Experts` leaf (3 a layer with every expert leaf int8)."""
    return sum(isinstance(m, Int8Experts) for m in model.modules())


class MoeMlp(nn.Module):
    """Expert bank: stacked SwiGLU experts [E, ...] and the top-2 router."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        E, M, F = cfg.num_experts, cfg.embed_dim, cfg.mlp_dim
        self.router = Dense(M, E, cfg)
        self.w_gate = nn.Parameter(torch.empty(E, M, F, dtype=cfg.param_dtype))
        self.w_up = nn.Parameter(torch.empty(E, M, F, dtype=cfg.param_dtype))
        self.w_down = nn.Parameter(torch.empty(E, F, M,
                                               dtype=cfg.param_dtype))
        self.gate = Top2GateConfig(
            num_experts=E, capacity_factor=cfg.capacity_factor,
            jitter_eps=cfg.router_jitter, dispatch=cfg.moe_dispatch)

    def experts(self, e_in: torch.Tensor) -> torch.Tensor:
        """The expert MLPs on their buffers [E, C, M] -> [E, C, M]."""
        gate = _expert_product(e_in, self.w_gate)
        up = _expert_product(e_in, self.w_up)
        return _expert_product(swiglu(gate, up), self.w_down)

    def forward(self, x: torch.Tensor, *, defer: bool = False):
        """[..., M] -> [..., M]; ``defer``: a :class:`~kubeflow_tpu_torch.
        ops.moe.Combine` of the tokens' rows instead (K14's inputs)."""
        M = x.shape[-1]
        logits = self.router(x)          # routed in f32 (K12 widens it)
        out, _ = moe_dispatch(x.reshape(-1, M),
                              logits.reshape(-1, logits.shape[-1]),
                              self.experts, self.gate, defer=defer)
        return out if defer else out.view(x.shape)


class MixtralLayer(DecoderLayer):
    """The Llama decoder layer with :class:`MoeMlp` as its MLP (the residual
    adds stay fused with the norms, K10; the closing one takes the MoE
    combine's inputs, ``ops/moe.py::combine_add_rms_norm``)."""

    MLP_CLS = MoeMlp

    def close(self, r, n, norm):
        return combine_add_rms_norm(r, self.mlp(n, defer=True), norm.weight,
                                    eps=norm.eps)

    def forward_remat(self, *args, **kwargs):
        raise NotImplementedError(
            "remat policies on a MoE layer are not ported yet (the Mixtral "
            "training slice, ROADMAP Queue 1 item 6c)")


class Mixtral(Llama):
    """Mixtral LM: the Llama backbone with MoE layers."""

    LAYER_CLS = MixtralLayer
    TRAINING_UNPORTED = (
        "training a MoE model is not ported yet: its aux-loss term, router "
        "jitter and the dispatch kernels' backward are the Mixtral training "
        "slice (ROADMAP Queue 1 item 6c)")

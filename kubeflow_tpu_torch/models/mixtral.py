"""Mixtral-style MoE transformer, the port of kubeflow_tpu.models.mixtral.

The Llama decoder with its MLP replaced by a bank of SwiGLU experts
behind a top-2 router (``parallel/moe.py``): the router is a
:class:`~kubeflow_tpu_torch.models.llama.Dense` [E, M] whose product, in
the activation dtype, the routing widens to f32; the experts hold the expert axis
first (``w_gate``, ``w_up`` [E, M, F], ``w_down`` [E, F, M], the JAX
layout), and run as batched products over the expert buffers with f32
accumulation rounded to the activation dtype (``torch.bmm``, as the JAX
package leaves its einsums to XLA), ``silu(gate) * up`` through K9. The
dispatch is the index dispatch of ``ops/moe.py`` (K12-K14 on the card).

Serving only, in this slice: the remat policies and the trainer raise
NotImplementedError on a Mixtral model (their aux-loss term, jitter and
the kernels' backward are the Mixtral training slice, ROADMAP Queue 1
item 6c), and so does the serving engine's int8 weights (item 6b).
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
        dtype = e_in.dtype
        gate = torch.bmm(e_in, self.w_gate.to(dtype))
        up = torch.bmm(e_in, self.w_up.to(dtype))
        return torch.bmm(swiglu(gate, up), self.w_down.to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        M = x.shape[-1]
        logits = self.router(x)          # routed in f32 (K12 widens it)
        out, _ = moe_dispatch(x.reshape(-1, M),
                              logits.reshape(-1, logits.shape[-1]),
                              self.experts, self.gate)
        return out.view(x.shape)


class MixtralLayer(DecoderLayer):
    """The Llama decoder layer with :class:`MoeMlp` as its MLP (the residual
    adds stay fused with the norms, K10)."""

    MLP_CLS = MoeMlp

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
    # The JAX engine's scales on an expert leaf [E, M, F] reduce over the
    # expert axis (one scale an element, shared by the experts): a layout
    # K4 does not take yet.
    INT8_UNPORTED = ("int8 weights on a MoE model are not ported yet "
                     "(ROADMAP Queue 1 item 6b)")

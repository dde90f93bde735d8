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
rows, in K14's place). The experts take the gather's inputs too
(``moe_dispatch(defer_gather=True)``): :func:`gate_up_swiglu` alone
decides whether the rows are gathered (K13) or read by the fused int8
launch.

With the serving engine's int8 weights (``ServingConfig.quantize="int8"``)
each expert leaf becomes an :class:`Int8Experts` (one bf16 scale an
element, shared by the experts, as the JAX engine quantizes the leaf over
its expert axis) whose product runs through
:func:`~kubeflow_tpu_torch.ops.int8_experts.int8_experts` (K15 on the
card); the attention projections and the lm_head become ``Int8Dense`` (K4),
as on Llama; the router [E, M] stays bf16 below ``quantize_min_size``. On
the card, at most ``DECODE_MAX_ROWS`` rows an expert (a decode step's),
int8 gate and up run as one launch that gathers the token rows and ends
in SwiGLU (:func:`~kubeflow_tpu_torch.ops.int8_experts.
int8_experts_swiglu`), in place of K13, two K15 launches and K9.

Training runs through the same layers: the dispatch's ops have backward
kernels (K16-K18, ``ops/moe.py``), each layer's aux loss leaves
``Llama.forward(return_aux=True)`` as their mean, and :class:`MoeMlp`
splits into :meth:`MoeMlp.products` (the routing, the gather and gate/up:
the JAX tags "moe_route", "mlp_gate", "mlp_up") and :meth:`MoeMlp.reduce`
(SwiGLU, down and the combine), so ``DecoderLayer.forward_remat`` serves
every remat policy on a :class:`MixtralLayer`. Router jitter
(``router_jitter > 0``) is not ported: the trainer raises on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from kubeflow_tpu_torch.models.llama import (
    DecoderLayer,
    Dense,
    Llama,
    LlamaConfig,
)
from kubeflow_tpu_torch.ops.int8_experts import (
    DECODE_MAX_ROWS,
    SWIGLU_MAX_TOKENS,
    int8_experts,
    int8_experts_swiglu,
)
from kubeflow_tpu_torch.ops.moe import (
    Gather,
    combine_add_rms_norm,
    combine_rows,
)
from kubeflow_tpu_torch.ops.swiglu import swiglu
from kubeflow_tpu_torch.parallel.moe import (
    Top2GateConfig,
    expert_rows,
    moe_dispatch,
    route_tokens,
)


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


def fused_route(w_gate, w_up, rows: int, tokens: int) -> bool:
    """Whether gate and up take the fused launch: int8 leaves on the card,
    at most ``DECODE_MAX_ROWS`` rows an expert of at most
    ``SWIGLU_MAX_TOKENS`` tokens."""
    return (isinstance(w_gate, Int8Experts) and isinstance(w_up, Int8Experts)
            and w_gate.weight.is_cuda and rows <= DECODE_MAX_ROWS
            and tokens <= SWIGLU_MAX_TOKENS)


def gate_up_swiglu(g: Gather, shape, w_gate, w_up) -> torch.Tensor:
    """``silu(gate) * up`` [E, R, F] of the expert buffers [E, R, M] =
    ``shape`` that ``g`` gathers. The one place that picks the route
    (:func:`fused_route`, by the leaves' types and the shapes): one fused
    launch that reads the rows by ``slot_tok``, or the gather (K13), the
    two products (K15 or ``torch.bmm``) and K9."""
    if fused_route(w_gate, w_up, shape[1], g.x.shape[0]):
        dt = w_gate.dtype
        return int8_experts_swiglu(
            g.x.to(dt), g.slot_tok, g.slot_valid.to(dt), w_gate.weight,
            w_gate.scale, w_up.weight, w_up.scale, shape[1])
    e_in = g.materialize().view(shape)
    return swiglu(_expert_product(e_in, w_gate), _expert_product(e_in, w_up))


def fused_layers(model: nn.Module, tokens: int) -> int:
    """MoE layers of ``model`` whose gate and up take the fused launch in
    a forward pass over ``tokens`` rows."""
    return sum(fused_route(m.w_gate, m.w_up, expert_rows(tokens, m.gate),
                           tokens)
               for m in model.modules() if isinstance(m, MoeMlp))


def expert_launches_per_pass(model: nn.Module,
                             tokens: Optional[int] = None) -> int:
    """K15 launches in one forward pass of ``model`` over ``tokens`` rows:
    one an :class:`Int8Experts` leaf (3 a layer with every expert leaf
    int8), but one for gate and up where they take the fused launch (2 a
    layer: a decode step's). ``tokens`` None: a pass without it."""
    return (sum(isinstance(m, Int8Experts) for m in model.modules())
            - (fused_layers(model, tokens) if tokens else 0))


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

    def experts(self, g: Gather, shape) -> torch.Tensor:
        """The expert MLPs on the buffers [E, C, M] = ``shape`` that ``g``
        gathers -> [E, C, M]."""
        return _expert_product(gate_up_swiglu(g, shape, self.w_gate,
                                              self.w_up), self.w_down)

    def forward(self, x: torch.Tensor, *, defer: bool = False):
        """[..., M] -> [..., M]; ``defer``: a :class:`~kubeflow_tpu_torch.
        ops.moe.Combine` of the tokens' rows instead (K14's inputs)."""
        M = x.shape[-1]
        logits = self.router(x)          # routed in f32 (K12 widens it)
        out, _ = moe_dispatch(x.reshape(-1, M),
                              logits.reshape(-1, logits.shape[-1]),
                              self.experts, self.gate, defer=defer,
                              defer_gather=True)
        return out if defer else out.view(x.shape)

    def products(self, x: torch.Tensor):
        """What the JAX "minimal" policy saves of the layer on x [..., M]:
        the routing ("moe_route": dest1, dest2, slot_tok, g1, g2) and gate,
        up [E, C, F] ("mlp_gate", "mlp_up"; ``torch.bmm`` over the
        gathered buffers, K13). :meth:`reduce` finishes the layer."""
        M = x.shape[-1]
        x2 = x.reshape(-1, M)
        d = route_tokens(x2, self.router(x).reshape(x2.shape[0], -1),
                         self.gate)
        e_in = d.gather(x2).materialize().view(d.shape)
        r = d.routing
        return (r.dest1, r.dest2, r.slot_tok, r.g1, r.g2,
                _expert_product(e_in, self.w_gate),
                _expert_product(e_in, self.w_up))

    def reduce(self, dest1, dest2, slot_tok, g1, g2, gate, up):
        """The tokens' outputs [T, M] of :meth:`products`' tensors:
        down(silu(gate) * up) (K9, ``torch.bmm``), combined (K14)."""
        y = _expert_product(swiglu(gate, up), self.w_down)
        return combine_rows(y.reshape(-1, y.shape[-1]), g1, g2, dest1,
                            dest2, slot_tok)


class MixtralLayer(DecoderLayer):
    """The Llama decoder layer with :class:`MoeMlp` as its MLP (the residual
    adds stay fused with the norms, K10; without grad the closing one
    takes the MoE combine's inputs, ``ops/moe.py::combine_add_rms_norm``)."""

    MLP_CLS = MoeMlp

    def close(self, r, n, norm):
        if torch.is_grad_enabled():
            # K10's combine mode has no backward: the combine (K14), then
            # the add + norm (K10).
            return super().close(r, n, norm)
        return combine_add_rms_norm(r, self.mlp(n, defer=True), norm.weight,
                                    eps=norm.eps)


class Mixtral(Llama):
    """Mixtral LM: the Llama backbone with MoE layers."""

    LAYER_CLS = MixtralLayer

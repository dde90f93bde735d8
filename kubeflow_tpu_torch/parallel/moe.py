"""Top-2 gating with static capacity, the port of kubeflow_tpu.parallel.moe.

GShard top-2 routing: each token picks two experts, each expert takes at
most C tokens a group (its capacity), second choices queue behind every
first choice, and a token's surviving weights are renormalised. Dispatch
is by index (``_moe_dispatch_gather`` of the JAX package): the routing
(K12), one row gather into the expert buffers [E, G * C, M] (K13) and
one weighted two-row combine (K14), the three kernels of
``ops/moe.py``; the expert function runs on the buffers in between.

Routing depends on the whole batch: every row fed to the layer takes
capacity, so two callers agree on a token's output only when they feed
the same rows.

What this port leaves out, each raising NotImplementedError: the
``einsum`` dispatch (GShard's dense one-hot products, the regime of
experts sharded over a mesh: ROADMAP Queue 1 item 5) and router jitter
(``rng`` with ``jitter_eps > 0``, a training option: item 6c). The port
has no mesh, so ``dispatch="auto"`` means gather.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from kubeflow_tpu_torch.ops.moe import (
    combine_rows,
    gather_rows,
    route,
    route_groups_reference,
)
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("moe")


@dataclasses.dataclass(frozen=True)
class Top2GateConfig:
    num_experts: int
    capacity_factor: float = 1.25
    min_capacity: int = 4
    # Multiply router logits noise during training (0 disables).
    jitter_eps: float = 0.0
    # Tokens per dispatch group (GShard's G dimension); 0 = one group.
    group_size: int = 8192
    # "gather" (index dispatch), "einsum" (not ported: raises) or "auto"
    # (gather: the port has no mesh to shard experts over).
    dispatch: str = "auto"

    def capacity(self, num_tokens: int) -> int:
        cap = int(self.capacity_factor * num_tokens * 2 / self.num_experts)
        cap = max(cap, self.min_capacity)
        # Round up to a multiple of 4, as the JAX package does.
        return -(-cap // 4) * 4


def _no_jitter(cfg: Top2GateConfig, rng) -> None:
    if rng is not None and cfg.jitter_eps > 0.0:
        raise NotImplementedError(
            "router jitter is a training option, not ported yet (the "
            "Mixtral training slice, ROADMAP Queue 1 item 6c)")


def top2_routing_reference(logits: torch.Tensor, cfg: Top2GateConfig, *,
                           rng=None):
    """The plain version of the JAX ``top2_routing`` on one group of logits
    [T, E]: (e1, e2, p1, p2 [T] int32, g1, g2 [T] f32, aux scalar), in its
    order of operations (``ops/moe.py::route_groups_reference``)."""
    _no_jitter(cfg, rng)
    e1, e2, p1, p2, g1, g2, aux = route_groups_reference(
        logits[None], cfg.capacity(logits.shape[0]))
    return (e1[0].int(), e2[0].int(), p1[0].int(), p2[0].int(), g1[0],
            g2[0], aux[0])


def top2_gating(logits: torch.Tensor, cfg: Top2GateConfig, *, rng=None):
    """The dense one-hot form of :func:`top2_routing_reference`, the JAX
    ``top2_gating``: (combine [T, E, C] f32, dispatch bool [T, E, C],
    aux)."""
    T, E = logits.shape
    C = cfg.capacity(T)
    e1, e2, p1, p2, g1, g2, aux = top2_routing_reference(logits, cfg,
                                                         rng=rng)
    one_hot = torch.nn.functional.one_hot
    oh_e1 = one_hot(e1.long(), E).float() * (g1 > 0).float()[:, None]
    oh_e2 = one_hot(e2.long(), E).float() * (g2 > 0).float()[:, None]
    oh_p1 = one_hot(p1.long(), C).float()
    oh_p2 = one_hot(p2.long(), C).float()
    combine = (g1[:, None, None] * oh_e1[:, :, None] * oh_p1[:, None, :]
               + g2[:, None, None] * oh_e2[:, :, None] * oh_p2[:, None, :])
    return combine, combine > 0.0, aux


def _moe_dispatch_gather(
    x: torch.Tensor,
    router_logits: torch.Tensor,
    expert_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: Top2GateConfig,
    group: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index dispatch in groups of ``group`` tokens (0 or >= T: one
    group), each with its own capacity; the expert buffers are laid out
    [E, G * C, M]."""
    T, M = x.shape
    E = router_logits.shape[-1]
    g = group if 0 < group < T else T
    G = T // g
    C = cfg.capacity(g)
    r = route(router_logits.contiguous(), G, C, x.dtype)
    expert_in = gather_rows(x, r.slot_tok, r.slot_valid)
    expert_out = expert_fn(expert_in.view(E, G * C, M)).reshape(E * G * C, M)
    out = combine_rows(expert_out, r.g1, r.g2, r.dest1, r.dest2)
    return out, (r.aux.mean() if G > 1 else r.aux[0])


def moe_dispatch(
    x: torch.Tensor,
    router_logits: torch.Tensor,
    expert_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: Top2GateConfig,
    *,
    rng=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route tokens x [T, M] through the experts by ``router_logits`` [T,
    E] (routed in f32); ``expert_fn`` maps [E, C, M] -> [E, C, M] in x's
    dtype. Returns ([T, M] outputs in x's dtype, aux loss: the groups'
    mean). Groups as the JAX
    package forms them (:func:`group_tokens`)."""
    T, _ = x.shape
    if cfg.dispatch == "einsum":
        raise NotImplementedError(
            "einsum MoE dispatch (the expert-sharded mesh regime) is not "
            "ported yet (the multi-GPU slice, ROADMAP Queue 1 item 5)")
    if cfg.dispatch not in ("auto", "gather"):
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r} (auto, "
                         "gather or einsum)")
    _no_jitter(cfg, rng)
    return _moe_dispatch_gather(x, router_logits, expert_fn, cfg,
                                group_tokens(T, cfg))


def group_tokens(num_tokens: int, cfg: Top2GateConfig) -> int:
    """Tokens a dispatch group for ``num_tokens`` tokens (0 or >= T: one
    group): ``group_size``, or, when it does not divide T, the largest
    divisor of T from ``group_size`` down to 32, else 0."""
    T, g = num_tokens, cfg.group_size
    if 0 < g < T and T % g != 0:
        g = next((d for d in range(g, 31, -1) if T % d == 0), 0)
        if g == 0:
            log.warning("no usable dispatch group size; routing the tokens "
                        "as one group",
                        kv={"tokens": T, "group_size": cfg.group_size})
    return g

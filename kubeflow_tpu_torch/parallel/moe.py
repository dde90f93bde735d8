"""Top-2 gating with static capacity, the port of kubeflow_tpu.parallel.moe.

GShard top-2 routing: each token picks two experts, each expert takes at
most C tokens a group (its capacity), second choices queue behind every
first choice, and a token's surviving weights are renormalised. Dispatch
is by index (``_moe_dispatch_gather`` of the JAX package): the routing
(K12), one row gather into the expert buffers [E, G * C, M] (K13) and
one weighted two-row combine (K14), the three kernels of
``ops/moe.py``; the expert function runs on the buffers in between. A
caller that adds the layer's output to the residual stream may ask for
the combine deferred (``defer=True``): the dispatch then returns a
:class:`~kubeflow_tpu_torch.ops.moe.Combine`, K14's inputs, for
``ops/moe.py::combine_add_rms_norm``. An expert function that gathers
its own rows may ask for the gather deferred (``defer_gather=True``): it
then receives a :class:`~kubeflow_tpu_torch.ops.moe.Gather`, K13's inputs,
and the buffers' shape.

Routing depends on the whole batch: every row fed to the layer takes
capacity, so two callers agree on a token's output only when they feed
the same rows.

Training differentiates the dispatch as the JAX package's custom VJPs
and autodiff do (``ops/moe.py``'s backward kernels K16-K18): the output
in x and in the experts' outputs, and the routing weights and the aux
loss in the router logits. The aux loss is returned (the groups' mean,
a differentiable scalar) and, inside :func:`aux_losses`, also collected,
as the JAX ``MoeMlp`` sows it into its "losses" collection.

What this port leaves out, each raising NotImplementedError: the
``einsum`` dispatch (GShard's dense one-hot products, the regime of
experts sharded over a mesh: ROADMAP Queue 1 item 5) and router jitter
(``rng`` with ``jitter_eps > 0``, a training option: item 6c). The port
has no mesh, so ``dispatch="auto"`` means gather.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from kubeflow_tpu_torch.ops.moe import (
    Combine,
    Gather,
    Routing,
    combine_rows,
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
            "router jitter is a training option, not ported yet (ROADMAP "
            "Queue 1 item 6c, open for jitter alone)")


_SOWN: contextvars.ContextVar[Optional[List[torch.Tensor]]] = \
    contextvars.ContextVar("moe_aux_losses", default=None)


@contextlib.contextmanager
def aux_losses():
    """Collect the aux loss of every dispatch routed inside the block, in
    order: the list it yields (the JAX ``MoeMlp``'s ``sow("losses",
    "moe_aux_loss", aux)``). ``Llama.forward(return_aux=True)`` opens it
    around its layers only: the backward's replays of checkpointed
    segments run after it closed, so they add nothing."""
    sown: List[torch.Tensor] = []
    token = _SOWN.set(sown)
    try:
        yield sown
    finally:
        _SOWN.reset(token)


class Dispatch(NamedTuple):
    """What :func:`route_tokens` gives: the routing of T tokens, the
    expert buffers' shape (E, G * C, M) and the aux loss (the groups'
    mean)."""

    routing: Routing
    shape: Tuple[int, int, int]
    aux: torch.Tensor

    def gather(self, x: torch.Tensor) -> Gather:
        """K13's inputs for the tokens x [T, M]."""
        r = self.routing
        return Gather(x, r.slot_tok, r.slot_valid, r.dest1, r.dest2)

    def combine(self, expert_out: torch.Tensor) -> Combine:
        """K14's inputs for the experts' outputs [E, G * C, M]."""
        r = self.routing
        return Combine(expert_out.reshape(-1, self.shape[2]), r.g1, r.g2,
                       r.dest1, r.dest2)


def route_tokens(x: torch.Tensor, router_logits: torch.Tensor,
                 cfg: Top2GateConfig, *, rng=None) -> Dispatch:
    """The routing of tokens x [T, M] by ``router_logits`` [T, E] (K12),
    in groups as :func:`moe_dispatch` forms them. Its aux loss joins an
    open :func:`aux_losses` list."""
    T, M = x.shape
    if cfg.dispatch == "einsum":
        raise NotImplementedError(
            "einsum MoE dispatch (the expert-sharded mesh regime) is not "
            "ported yet (the multi-GPU slice, ROADMAP Queue 1 item 5)")
    if cfg.dispatch not in ("auto", "gather"):
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r} (auto, "
                         "gather or einsum)")
    _no_jitter(cfg, rng)
    E = router_logits.shape[-1]
    g = group_tokens(T, cfg)
    g = g if 0 < g < T else T
    G = T // g
    C = cfg.capacity(g)
    r = route(router_logits.contiguous(), G, C, x.dtype)
    aux = r.aux.mean() if G > 1 else r.aux[0]
    sown = _SOWN.get()
    if sown is not None:
        sown.append(aux)
    return Dispatch(r, (E, G * C, M), aux)


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


def moe_dispatch(
    x: torch.Tensor,
    router_logits: torch.Tensor,
    expert_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: Top2GateConfig,
    *,
    rng=None,
    defer: bool = False,
    defer_gather: bool = False,
) -> Tuple[Union[torch.Tensor, Combine], torch.Tensor]:
    """Route tokens x [T, M] through the experts by ``router_logits`` [T,
    E] (routed in f32); ``expert_fn`` maps [E, C, M] -> [E, C, M] in x's
    dtype. Returns ([T, M] outputs in x's dtype, aux loss: the groups'
    mean). Groups as the JAX package forms them (:func:`group_tokens`),
    each with its own capacity; the expert buffers are laid out [E, G * C,
    M]. ``defer`` (inference): a :class:`Combine` in place of the outputs;
    ``defer_gather``: ``expert_fn`` takes a :class:`Gather` and the
    buffers' shape (E, C, M) in place of the buffers (K13's launch left
    to it)."""
    d = route_tokens(x, router_logits, cfg, rng=rng)
    g = d.gather(x)
    expert_out = (expert_fn(g, d.shape) if defer_gather
                  else expert_fn(g.materialize().view(d.shape)))
    combine = d.combine(expert_out)
    if defer:
        return combine, d.aux
    return combine_rows(*combine, slot_tok=d.routing.slot_tok), d.aux


def expert_rows(num_tokens: int, cfg: Top2GateConfig) -> int:
    """Rows an expert's buffer holds when :func:`moe_dispatch` routes
    ``num_tokens`` tokens: G groups times the capacity C of each."""
    g = group_tokens(num_tokens, cfg)
    g = g if 0 < g < num_tokens else num_tokens
    return num_tokens // g * cfg.capacity(g)


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

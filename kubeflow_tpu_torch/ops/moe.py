"""Top-2 MoE dispatch by index: the routing (K12), the row gather into the
expert buffers (K13) and the weighted two-row combine (K14), each a CUDA
kernel with its plain PyTorch version beside it.

They replace the XLA fusions of ``kubeflow_tpu/parallel/moe.py``'s gather
dispatch: ``top2_routing`` (:57-114) with the index maps of
``_moe_dispatch_gather`` (:253-290), ``_gather_in`` (:159-165) and
``_combine_out`` (:187-198). The buffers are laid out as there: expert e,
group q and capacity position c hold slot ``e * G * C + q * C + c`` of
``S = E * G * C``; a dropped choice points at ``S``, the trash row, which
the combine reads as 0.

- :func:`route` (K12) takes the router logits [T, E] (f32, or the
  activations' bf16, widened exactly) split into G
  groups of g = T / G tokens with capacity C (the only host values) and
  returns a :class:`Routing`: per token the first and second choice's slot
  (``dest1``, ``dest2``) and renormalised weight (``g1``, ``g2``, 0 for a
  dropped choice), per slot the token it holds (``slot_tok``) and whether
  a choice holds it (``slot_valid``, in the activations' dtype), and each
  group's load-balancing loss (``aux``). On the card it is one launch of
  one of two forms, chosen by g: a warp a group (g <= 32, a decode step)
  or a block or thread-block cluster a group (g > 32, at most
  :data:`MAX_GROUP_TOKENS`).
- :func:`gather_rows` (K13): ``expert_in[s] = x[slot_tok[s]] * slot_valid[s]``.
  A :class:`Gather` holds its inputs instead, for an expert function that
  reads the rows by ``slot_tok`` itself (``ops/int8_experts.py``'s fused
  gate/up launch at a decode step's rows).
- :func:`combine_rows` (K14): ``out[t] = g1[t] y[dest1[t]] + g2[t]
  y[dest2[t]]`` in f32, rounded once to the output dtype. A
  :class:`Combine` holds its inputs instead, for a layer whose output
  goes straight into the residual add + RMSNorm:
  :func:`combine_add_rms_norm` makes both, up to ``ops/norms.py``'s
  ROWS_MAX rows in one launch of K10's combine mode (the same rows in
  front of the add, bitwise, without K14's launch), above it K14 then
  K10.

The plain versions (:func:`route_reference`, :func:`gather_rows_reference`,
:func:`combine_rows_reference`) fix the order of every sum: the softmax's
denominator and the aux loss's sum over the experts left to right, the
mean of the gates over a group's tokens by folding halves (the tokens
padded with zeros to a power of two, then ``x[:h] + x[h:]`` until one is
left). The kernels keep that order with one rounded f32 operation per
tensor operation, so they agree bitwise: integer outputs equal, the
floating ones bitwise. The group form splits the fold over its blocks in
the order :func:`aux_fold_reference` states, which is the same sum.

Under grad each op is a ``torch.autograd.Function`` whose backward is a
kernel too (the JAX package's custom VJPs and the autodiff of its
routing):

- :func:`gather_rows_backward` (K16, ``_gather_in_bwd``): ``dx[t] =
  d[dest1[t]] + d[dest2[t]]`` (row S read as 0), K14's kernel with unit
  weights: the two rows widened exactly, added in f32 and rounded once,
  which is JAX's bf16 add;
- :func:`combine_rows_backward` (K17, ``_combine_out_bwd``): ``dy[s] = w_s
  dout[slot_tok[s]]`` (w_s the weight of the choice that holds slot s, 0
  for an empty slot) and ``dg_k[t] = dout[t] . y[dest_k[t]]`` in f32, in
  :func:`row_dot_reference`'s order;
- :func:`route_backward` (K18): the gradient of g1, g2 and aux with
  respect to the logits, :func:`route_backward_reference`'s formula.

So the gather needs the routing's ``dest1``, ``dest2`` and the combine its
``slot_tok`` when their inputs require grad.

CUDA tensors launch ``ops/csrc/moe.cu`` (built at first use by
``ops/_build.py``) or raise; CPU tensors take the plain versions. Each
launch adds one to ``route.launches``, ``gather_rows.launches``,
``combine_rows.launches``, ``gather_rows_backward.launches``,
``combine_rows_backward.launches`` or ``route_backward.launches`` (K10's
combine mode counts in ``ops/norms.py``'s
``add_rms_norm.combine_launches``). No kernel reads a device value on the
host, so a CUDA graph captures them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from kubeflow_tpu_torch.ops.norms import (
    ROWS_MAX,
    add_rms_norm,
    add_rms_norm_combine,
)

_SOURCE = "moe.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: K12 holds a token's choice among at most this many experts.
MAX_EXPERTS = 64
#: The most tokens a group K12's group form routes (its aux fold keeps a
#: stack of 11 partial sums a warp).
MAX_GROUP_TOKENS = 1 << 18


class Routing(NamedTuple):
    dest1: torch.Tensor       # [T] int32 slot of the first choice, or S
    dest2: torch.Tensor       # [T] int32 slot of the second choice, or S
    g1: torch.Tensor          # [T] f32 weight of the first choice
    g2: torch.Tensor          # [T] f32 weight of the second choice
    slot_tok: torch.Tensor    # [S] int32 token a slot holds (0 if empty)
    slot_valid: torch.Tensor  # [S] 1 where a choice holds the slot, else 0
    aux: torch.Tensor         # [G] f32 load-balancing loss of each group


class Gather(NamedTuple):
    """K13's inputs with its launch left to the expert function: the
    tokens ``x`` [T, M] and the routing's ``slot_tok``, ``slot_valid``
    [S] (and ``dest1``, ``dest2`` [T], which its backward reads);
    :meth:`materialize` gives the expert buffers [S, M] (K13)."""

    x: torch.Tensor
    slot_tok: torch.Tensor
    slot_valid: torch.Tensor
    dest1: Optional[torch.Tensor] = None
    dest2: Optional[torch.Tensor] = None

    def materialize(self) -> torch.Tensor:
        return gather_rows(*self)


class Combine(NamedTuple):
    """K14's inputs with its launch left to the caller: the expert outputs
    ``y`` [S, M] and the routing's ``g1``, ``g2``, ``dest1``, ``dest2``
    [T]. :func:`combine_add_rms_norm` adds its rows to the residual
    stream; :meth:`materialize` gives them as [T, M] (K14). Inference
    only: under grad the combine is :func:`combine_rows` with the
    routing's ``slot_tok``."""

    y: torch.Tensor
    g1: torch.Tensor
    g2: torch.Tensor
    dest1: torch.Tensor
    dest2: torch.Tensor

    def materialize(self) -> torch.Tensor:
        return combine_rows(*self)


# ------------------------------------------------------------ plain versions


def _serial_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def _fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` by folding halves: zeros pad it to a power of two
    P, then ``x[:h] + x[h:2h]`` for h = P/2, P/4, .., 1."""
    n = x.shape[dim]
    p = 1
    while p < n:
        p *= 2
    if p > n:
        shape = list(x.shape)
        shape[dim] = p - n
        x = torch.cat([x, x.new_zeros(shape)], dim)
    while p > 1:
        p //= 2
        x = x.narrow(dim, 0, p) + x.narrow(dim, p, p)
    return x.squeeze(dim)


def aux_fold_reference(x: torch.Tensor, blocks: int) -> torch.Tensor:
    """:func:`_fold_sum` over dim 0 of x [n, ...] in the order K12's group
    form takes it over ``blocks`` blocks (a power of two up to P, the
    padded length): block b folds by halves the rows b, b + blocks, ..
    (zeros past n, up to P / blocks of them), then the blocks' partials
    fold by halves in block order. Folding halves pairs rows i and i + h,
    so its first levels pair rows of one residue mod ``blocks``, and the
    two orders are one tree: bitwise equal. The kernel applies the same
    split again within a block (lanes, rounds, warps)."""
    n = x.shape[0]
    p = 1
    while p < n:
        p *= 2
    if blocks < 1 or blocks & (blocks - 1) or blocks > p:
        raise ValueError(f"blocks ({blocks}) must be a power of two up to "
                         f"{p}")
    if p > n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    parts = [_fold_sum(x[b::blocks], 0) for b in range(blocks)]
    return _fold_sum(torch.stack(parts), 0)


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, the first index on ties."""
    best = v[..., 0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=v.device)
    for j in range(1, v.shape[-1]):
        up = v[..., j] > best
        best = torch.where(up, v[..., j], best)
        idx = torch.where(up, j, idx)
    return idx


def _gates_top2(logits: torch.Tensor):
    """(gates, e1, e2) of logits [..., E]: the softmax (in f64 for f64
    logits, else f32) and the first and second choices, as K12 computes
    them."""
    lg = logits if logits.dtype == torch.float64 else logits.float()
    m = lg.amax(dim=-1, keepdim=True)
    ex = torch.exp(lg - m)
    gates = ex / _serial_sum(ex)[..., None]
    experts = torch.arange(lg.shape[-1], device=lg.device)
    e1 = _first_argmax(gates)
    e2 = _first_argmax(gates * (1 - (e1[..., None] == experts).long()))
    return gates, e1, e2


def route_groups_reference(logits: torch.Tensor, capacity: int):
    """GShard top-2 routing with static capacity, ``top2_routing`` of the
    JAX package in its order, on logits [G, g, E] (each group routed on its
    own): (e1, e2, p1, p2 [G, g] int64, g1, g2 [G, g] f32, aux [G] f32).

    The f32 softmax; the first choice its argmax, the second the argmax
    of the gates with the first zeroed (first index on ties); positions
    the exclusive running count of each expert's choices over the tokens,
    second choices queued behind ALL first choices of the expert (counted
    before the capacity mask); a choice at or past ``capacity`` is
    dropped (its weight and position 0) and the survivors renormalised
    over their sum where it is > 0; aux = E sum_e mean_t(gates) mean_t(first
    choice is e), taken before the capacity mask. f64 logits route in f64
    (the gradient checks), any other dtype in f32."""
    gates, e1, e2 = _gates_top2(logits)
    G, g, E = gates.shape
    experts = torch.arange(E, device=gates.device)
    mask1 = (e1[..., None] == experts).long()       # one-hot, no host sync
    mask2 = (e2[..., None] == experts).long()
    count1 = mask1.sum(dim=1, keepdim=True)                     # [G, 1, E]
    pos1 = (torch.cumsum(mask1, dim=1) - mask1).gather(-1, e1[..., None])
    pos2 = (torch.cumsum(mask2, dim=1) - mask2 + count1).gather(
        -1, e2[..., None])
    keep1, keep2 = pos1[..., 0] < capacity, pos2[..., 0] < capacity
    zero = gates.new_zeros(())
    g1 = torch.where(keep1, gates.gather(-1, e1[..., None])[..., 0], zero)
    g2 = torch.where(keep2, gates.gather(-1, e2[..., None])[..., 0], zero)
    denom = g1 + g2
    denom = torch.where(denom > 0, denom, gates.new_ones(()))
    # A tensor divisor: by a Python number the card multiplies by its
    # reciprocal, which for g not a power of two is not the division.
    n = gates.new_full((), float(g))
    me = _fold_sum(gates, 1) / n
    ce = count1[:, 0].float() / n
    aux = _serial_sum(me * ce) * E
    p1 = torch.where(keep1, pos1[..., 0], 0)
    p2 = torch.where(keep2, pos2[..., 0], 0)
    return e1, e2, p1, p2, g1 / denom, g2 / denom, aux


def route_reference(logits: torch.Tensor, groups: int, capacity: int,
                    slot_dtype: torch.dtype) -> Routing:
    """K12's plain version: :func:`route_groups_reference` on each of
    ``groups`` groups of logits [T, E], and the index maps of
    ``_moe_dispatch_gather``: a kept choice (weight > 0) of token t in
    group q goes to slot ``e * G * C + q * C + p``, a dropped one to S;
    ``slot_tok`` / ``slot_valid`` are set from dest1, then dest2 (kept
    slots are distinct, so neither overwrites the other)."""
    T, E = logits.shape
    G, C = groups, capacity
    e1, e2, p1, p2, w1, w2, aux = route_groups_reference(
        logits.reshape(G, T // G, E), C)
    S = E * G * C
    base = torch.arange(G, device=logits.device)[:, None] * C
    k1, k2 = w1 > 0, w2 > 0
    dest1 = torch.where(k1, e1 * (G * C) + base + p1, S).reshape(T)
    dest2 = torch.where(k2, e2 * (G * C) + base + p2, S).reshape(T)
    tok = torch.arange(T, dtype=torch.int32, device=logits.device)
    # One spare entry takes the dropped choices' writes, then goes.
    slot_tok = torch.zeros(S + 1, dtype=torch.int32, device=logits.device)
    slot_tok.scatter_(0, dest1, tok).scatter_(0, dest2, tok)
    slot_valid = torch.zeros(S + 1, dtype=slot_dtype, device=logits.device)
    slot_valid.scatter_(0, dest1, k1.reshape(T).to(slot_dtype))
    slot_valid.scatter_(0, dest2, k2.reshape(T).to(slot_dtype))
    return Routing(dest1.to(torch.int32), dest2.to(torch.int32),
                   w1.reshape(T), w2.reshape(T), slot_tok[:S],
                   slot_valid[:S], aux)


def gather_rows_reference(x: torch.Tensor, slot_tok: torch.Tensor,
                          slot_valid: torch.Tensor) -> torch.Tensor:
    """K13's plain version: x [T, M] -> [S, M], row s = x[slot_tok[s]] *
    slot_valid[s] (an empty slot holds token 0's row times 0)."""
    return x.index_select(0, slot_tok) * slot_valid[:, None]


def combine_rows_reference(y: torch.Tensor, g1: torch.Tensor,
                           g2: torch.Tensor, dest1: torch.Tensor,
                           dest2: torch.Tensor) -> torch.Tensor:
    """K14's plain version: y [S, M] with a zero row S appended; out[t] =
    g1[t] f32(y[dest1[t]]) + g2[t] f32(y[dest2[t]]), rounded to y's
    dtype."""
    yp = torch.cat([y, y.new_zeros(1, y.shape[1])])
    out = (g1[:, None] * yp.index_select(0, dest1).float()
           + g2[:, None] * yp.index_select(0, dest2).float())
    return out.to(y.dtype)


def gather_rows_backward_reference(d: torch.Tensor, dest1: torch.Tensor,
                                   dest2: torch.Tensor) -> torch.Tensor:
    """K16's plain version, the gather's backward (JAX ``_gather_in_bwd``):
    d [S, M] with a zero row S appended; dx[t] = f32(d[dest1[t]]) +
    f32(d[dest2[t]]), rounded once to d's dtype (K14 with unit weights:
    a product by 1 is exact)."""
    dp = torch.cat([d, d.new_zeros(1, d.shape[1])])
    return (dp.index_select(0, dest1).float()
            + dp.index_select(0, dest2).float()).to(d.dtype)


def row_dot_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot of each row of a, b [T, M] (f32) in K17's order: the
    products, zeros past M up to a multiple of 256, viewed [T, K, 32, 8]
    (lane l holds the 8-element chunks l, l + 32, ..); the K chunks summed
    in order, then the 8 partial sums folded by halves, then the 32
    lanes."""
    p = a * b
    T, M = p.shape
    K = -(-M // 256)
    if K * 256 > M:
        p = torch.cat([p, p.new_zeros(T, K * 256 - M)], 1)
    p = p.view(T, K, 32, 8)
    acc = p[:, 0]
    for k in range(1, K):
        acc = acc + p[:, k]
    return _fold_sum(_fold_sum(acc, 2), 1)


def combine_rows_backward_reference(dout: torch.Tensor, y: torch.Tensor,
                                    g1: torch.Tensor, g2: torch.Tensor,
                                    dest1: torch.Tensor, dest2: torch.Tensor,
                                    slot_tok: torch.Tensor):
    """K17's plain version, the combine's backward (JAX
    ``_combine_out_bwd``) for the cotangent dout [T, M] of
    :func:`combine_rows_reference`'s output, widened exactly to f32:
    (dy [S, M] in y's dtype, dg1, dg2 [T] f32). Slot s holds token t =
    slot_tok[s]: w_s = (g1[t] if dest1[t] == s else 0) + (g2[t] if
    dest2[t] == s else 0) (0 for an empty slot), dy[s] = w_s dout[t]
    rounded once; dg_k[t] = dout[t] . y[dest_k[t]] (row S read as 0) in
    :func:`row_dot_reference`'s order."""
    S = y.shape[0]
    slots = torch.arange(S, dtype=dest1.dtype, device=y.device)
    t = slot_tok.long()
    zero = g1.new_zeros(())
    w = (torch.where(dest1.index_select(0, t) == slots,
                     g1.index_select(0, t), zero)
         + torch.where(dest2.index_select(0, t) == slots,
                       g2.index_select(0, t), zero))
    d = dout.float()
    dy = (w[:, None] * d.index_select(0, t)).to(y.dtype)
    yp = torch.cat([y, y.new_zeros(1, y.shape[1])])
    dg1 = row_dot_reference(d, yp.index_select(0, dest1).float())
    dg2 = row_dot_reference(d, yp.index_select(0, dest2).float())
    return dy, dg1, dg2


def route_backward_reference(logits: torch.Tensor, dest1: torch.Tensor,
                             dest2: torch.Tensor, dg1: torch.Tensor,
                             dg2: torch.Tensor, daux: torch.Tensor,
                             groups: int, capacity: int) -> torch.Tensor:
    """K18's plain version: the gradient [T, E], in the logits' dtype, of
    :func:`route_reference`'s g1, g2 [T] and aux [G] with respect to the
    logits [T, E] (the autodiff of the JAX ``top2_routing``), from their
    cotangents dg1, dg2, daux and the forward's dest1, dest2.

    Per group of g tokens, in f32 (f64 for f64 logits), each step one
    rounded operation in this order: the gates, e1 and e2 as the forward
    computes them; kept_k = dest_k < S; a_k = gates[e_k] where kept_k,
    else 0; d = a1 + a2, 1 where it is 0 (no gradient flows through the
    1); w_k = a_k / d (the forward's g_k). Then

    - da_k = (dg_k - (dg1 w1 + dg2 w2)) / d for a kept choice, else 0
      (the renormalisation's derivative; a dropped choice's a_k is a
      constant 0);
    - dgates[e] = ([e == e1] da1 + [e == e2] da2) + ((daux E) (count1[e] /
      g)) / g, count1[e] the group's first choices of e before the
      capacity mask (aux = E sum_e mean_t(gates) count1 / g);
    - dl = gates (dgates - sum_e dgates gates), the sum left to right (the
      softmax's derivative)."""
    T, E = logits.shape
    G, C = groups, capacity
    g = T // G
    gates, e1, e2 = _gates_top2(logits.reshape(G, g, E))
    experts = torch.arange(E, device=logits.device)
    count1 = (e1[..., None] == experts).sum(dim=1)                 # [G, E]
    kept1 = (dest1 < E * G * C).reshape(G, g)
    kept2 = (dest2 < E * G * C).reshape(G, g)
    zero = gates.new_zeros(())
    a1 = torch.where(kept1, gates.gather(-1, e1[..., None])[..., 0], zero)
    a2 = torch.where(kept2, gates.gather(-1, e2[..., None])[..., 0], zero)
    den = a1 + a2
    den = torch.where(den > 0, den, gates.new_ones(()))
    w1, w2 = a1 / den, a2 / den
    d1 = dg1.reshape(G, g).to(gates.dtype)
    d2 = dg2.reshape(G, g).to(gates.dtype)
    dot = d1 * w1 + d2 * w2
    da1 = torch.where(kept1, (d1 - dot) / den, zero)
    da2 = torch.where(kept2, (d2 - dot) / den, zero)
    n = gates.new_full((), float(g))
    aux_grad = (daux.to(gates.dtype)[:, None] * E) * (count1.to(gates.dtype)
                                                       / n) / n
    dgates = (torch.where(experts == e1[..., None], da1[..., None], zero)
              + torch.where(experts == e2[..., None], da2[..., None], zero)
              + aux_grad[:, None, :])
    s = _serial_sum(dgates * gates)
    return (gates * (dgates - s[..., None])).reshape(T, E).to(logits.dtype)


# ------------------------------------------------------------------ kernels


def bind(lib: ctypes.CDLL):
    """K12-K14's C entry points (route, gather, combine) with their
    signatures."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    route_fn = lib.kftpu_moe_route
    route_fn.restype = i
    route_fn.argtypes = [p, i, ll, i, i, i, i] + [p] * 8
    gather_fn = lib.kftpu_moe_gather
    gather_fn.restype = i
    gather_fn.argtypes = [i, p, p, p, p, ll, i, p]
    combine_fn = lib.kftpu_moe_combine
    combine_fn.restype = i
    combine_fn.argtypes = [i, p, p, p, p, p, p, ll, ll, i, p]
    return route_fn, gather_fn, combine_fn


def bind_backward(lib: ctypes.CDLL):
    """K17's and K18's C entry points (combine's and route's backward; K16
    is K14's) with their signatures; apart from :func:`bind`, which
    ``kernel_ab.py`` also applies to builds that predate them."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    combine_bwd = lib.kftpu_moe_combine_backward
    combine_bwd.restype = i
    combine_bwd.argtypes = [i] + [p] * 10 + [ll, ll, i, p]
    route_bwd = lib.kftpu_moe_route_backward
    route_bwd.restype = i
    route_bwd.argtypes = [p, i, ll, i, i, i] + [p] * 7
    return combine_bwd, route_bwd


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    return bind(lib) + bind_backward(lib)


def _on_card(*ts: torch.Tensor) -> bool:
    devices = {t.device for t in ts}
    if len(devices) != 1 or next(iter(devices)).type not in ("cuda", "cpu"):
        raise ValueError(f"MoE dispatch ops run on one cuda device (kernels) "
                         f"or on the cpu (plain versions), got {devices}")
    return next(iter(devices)).type == "cuda"


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(rc: int, what: str, shape) -> None:
    if rc != 0:
        raise RuntimeError(f"MoE {what} launch failed: CUDA error {rc} "
                           f"({tuple(shape)})")


def _check_route(logits: torch.Tensor, groups: int, capacity: int) -> int:
    """S, the slot count, of a routing the kernels take; raises on any
    other."""
    T, E = logits.shape
    S = E * groups * capacity
    if logits.dtype not in _DTYPES or not logits.is_contiguous() \
            or E > MAX_EXPERTS or S >= 2 ** 31 or T >= 2 ** 31 \
            or T // groups > MAX_GROUP_TOKENS:
        raise ValueError(f"MoE routing kernels take contiguous f32 or bf16 "
                         f"logits [T, E] with E <= {MAX_EXPERTS}, groups of "
                         f"at most {MAX_GROUP_TOKENS} tokens and fewer than "
                         f"2^31 slots; got {logits.dtype} "
                         f"{tuple(logits.shape)} stride {logits.stride()}, "
                         f"{groups} groups, {S} slots")
    return S


def _route(logits: torch.Tensor, groups: int, capacity: int,
           slot_dtype: torch.dtype) -> Routing:
    if not _on_card(logits):
        return route_reference(logits, groups, capacity, slot_dtype)
    T, E = logits.shape
    S = _check_route(logits, groups, capacity)
    if slot_dtype not in _DTYPES:
        raise ValueError(f"route kernel takes a bf16 or f32 slot dtype, got "
                         f"{slot_dtype}")
    dev = logits.device

    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    out = Routing(empty(T, torch.int32), empty(T, torch.int32),
                  empty(T, torch.float32), empty(T, torch.float32),
                  empty(S, torch.int32), empty(S, slot_dtype),
                  empty(groups, torch.float32))
    with torch.cuda.device(dev):
        rc = _kernel_fns()[0](
            logits.data_ptr(), _DTYPES[logits.dtype], T, E, groups, capacity,
            _DTYPES[slot_dtype], *(t.data_ptr() for t in out),
            _stream(logits))
    _launched(rc, "route", logits.shape)
    route.launches += 1
    return out


class _Route(torch.autograd.Function):
    """K12 with K18 as its backward: g1, g2 and aux are differentiable in
    the logits; the index maps and slot_valid are not."""

    @staticmethod
    def forward(ctx, logits, groups, capacity, slot_dtype):
        r = _route(logits, groups, capacity, slot_dtype)
        ctx.mark_non_differentiable(r.dest1, r.dest2, r.slot_tok,
                                    r.slot_valid)
        ctx.save_for_backward(logits, r.dest1, r.dest2)
        ctx.groups, ctx.capacity = groups, capacity
        return tuple(r)

    @staticmethod
    def backward(ctx, _d1, _d2, dg1, dg2, _tok, _valid, daux):
        logits, dest1, dest2 = ctx.saved_tensors
        dl = route_backward(logits, dest1, dest2, dg1.contiguous(),
                            dg2.contiguous(), daux.contiguous(), ctx.groups,
                            ctx.capacity)
        return dl, None, None, None


def route(logits: torch.Tensor, groups: int, capacity: int,
          slot_dtype: torch.dtype) -> Routing:
    """Top-2 routing of logits [T, E] (f32 or bf16; the routing is f32)
    in ``groups`` groups of ``capacity`` slots an expert (K12 on the card:
    one launch, a warp a group of up to 32 tokens, else a block or a
    cluster of blocks a group, about 512 tokens a block). Logits that
    require grad make g1, g2 and aux differentiable (K18 the backward)."""
    T, E = logits.shape
    if groups < 1 or T % groups or capacity < 1 or E < 2:
        raise ValueError(f"route takes T ({T}) a multiple of groups "
                         f"({groups}), capacity >= 1 ({capacity}) and at "
                         f"least 2 experts ({E})")
    if _needs_grad(logits):
        return Routing(*_Route.apply(logits, groups, capacity, slot_dtype))
    return _route(logits, groups, capacity, slot_dtype)


def route_backward(logits: torch.Tensor, dest1: torch.Tensor,
                   dest2: torch.Tensor, dg1: torch.Tensor, dg2: torch.Tensor,
                   daux: torch.Tensor, groups: int,
                   capacity: int) -> torch.Tensor:
    """The gradient [T, E] of the routing's g1, g2 and aux with respect
    to the logits [T, E] (K18 on the card: one launch, a cluster of blocks
    a group; :func:`route_backward_reference` on the CPU)."""
    if not _on_card(logits, dest1, dest2, dg1, dg2, daux):
        return route_backward_reference(logits, dest1, dest2, dg1, dg2,
                                        daux, groups, capacity)
    T, E = logits.shape
    _check_route(logits, groups, capacity)
    for name, t, n, dtype in (("dest1", dest1, T, torch.int32),
                              ("dest2", dest2, T, torch.int32),
                              ("dg1", dg1, T, torch.float32),
                              ("dg2", dg2, T, torch.float32),
                              ("daux", daux, groups, torch.float32)):
        _index(name, t, n, dtype)
    dl = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        rc = _kernel_fns()[4](
            logits.data_ptr(), _DTYPES[logits.dtype], T, E, groups, capacity,
            dest1.data_ptr(), dest2.data_ptr(), dg1.data_ptr(),
            dg2.data_ptr(), daux.data_ptr(), dl.data_ptr(), _stream(logits))
    _launched(rc, "route backward", logits.shape)
    route_backward.launches += 1
    return dl


def _rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or not t.is_contiguous() or t.dtype not in _DTYPES \
            or t.shape[1] % 8 or t.data_ptr() % 16:
        raise ValueError(f"MoE {name} kernel takes contiguous, 16-byte "
                         f"aligned bf16 or f32 rows [n, M] with M a multiple "
                         f"of 8, got {t.dtype} {tuple(t.shape)} stride "
                         f"{t.stride()}")


def _index(name: str, t: torch.Tensor, n: int, dtype) -> None:
    if t.shape != (n,) or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"MoE kernel takes {name} [{n}] {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _gather_rows(x: torch.Tensor, slot_tok: torch.Tensor,
                 slot_valid: torch.Tensor) -> torch.Tensor:
    if not _on_card(x, slot_tok, slot_valid):
        return gather_rows_reference(x, slot_tok, slot_valid)
    _rows("gather", x)
    S = slot_tok.shape[0]
    _index("slot_tok", slot_tok, S, torch.int32)
    _index("slot_valid", slot_valid, S, x.dtype)
    out = torch.empty(S, x.shape[1], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_fns()[1](_DTYPES[x.dtype], x.data_ptr(),
                              slot_tok.data_ptr(), slot_valid.data_ptr(),
                              out.data_ptr(), S, x.shape[1], _stream(x))
    _launched(rc, "gather", out.shape)
    gather_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """K13 with K16 as its backward."""

    @staticmethod
    def forward(ctx, x, slot_tok, slot_valid, dest1, dest2):
        ctx.save_for_backward(dest1, dest2)
        return _gather_rows(x, slot_tok, slot_valid)

    @staticmethod
    def backward(ctx, d):
        dest1, dest2 = ctx.saved_tensors
        return (gather_rows_backward(d.contiguous(), dest1, dest2), None,
                None, None, None)


def gather_rows(x: torch.Tensor, slot_tok: torch.Tensor,
                slot_valid: torch.Tensor, dest1: Optional[torch.Tensor] = None,
                dest2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The expert buffers [S, M] of tokens x [T, M] (K13 on the card). x
    that requires grad needs the routing's dest1, dest2 (K16 the
    backward)."""
    if _needs_grad(x):
        if dest1 is None or dest2 is None:
            raise ValueError("the gather's backward (K16) reads dest1 and "
                             "dest2: pass them with an x that requires grad")
        return _GatherRows.apply(x, slot_tok, slot_valid, dest1, dest2)
    return _gather_rows(x, slot_tok, slot_valid)


def gather_rows_backward(d: torch.Tensor, dest1: torch.Tensor,
                         dest2: torch.Tensor) -> torch.Tensor:
    """The tokens' gradient [T, M] of the expert buffers' d [S, M] (K16 on
    the card: one launch of K14's kernel with unit weights)."""
    if not _on_card(d, dest1, dest2):
        return gather_rows_backward_reference(d, dest1, dest2)
    ones = torch.ones(dest1.shape[0], dtype=torch.float32, device=d.device)
    dx = _combine_launch(d, ones, ones, dest1, dest2)
    gather_rows_backward.launches += 1
    return dx


def _combine_launch(y, g1, g2, dest1, dest2) -> torch.Tensor:
    _rows("combine", y)
    T = dest1.shape[0]
    for name, t, dtype in (("g1", g1, torch.float32),
                           ("g2", g2, torch.float32),
                           ("dest1", dest1, torch.int32),
                           ("dest2", dest2, torch.int32)):
        _index(name, t, T, dtype)
    out = torch.empty(T, y.shape[1], dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = _kernel_fns()[2](_DTYPES[y.dtype], y.data_ptr(), g1.data_ptr(),
                              g2.data_ptr(), dest1.data_ptr(),
                              dest2.data_ptr(), out.data_ptr(), T,
                              y.shape[0], y.shape[1], _stream(y))
    _launched(rc, "combine", out.shape)
    return out


def _combine_rows(y, g1, g2, dest1, dest2) -> torch.Tensor:
    if not _on_card(y, g1, g2, dest1, dest2):
        return combine_rows_reference(y, g1, g2, dest1, dest2)
    out = _combine_launch(y, g1, g2, dest1, dest2)
    combine_rows.launches += 1
    return out


class _CombineRows(torch.autograd.Function):
    """K14 with K17 as its backward (y, g1 and g2 differentiable)."""

    @staticmethod
    def forward(ctx, y, g1, g2, dest1, dest2, slot_tok):
        ctx.save_for_backward(y, g1, g2, dest1, dest2, slot_tok)
        return _combine_rows(y, g1, g2, dest1, dest2)

    @staticmethod
    def backward(ctx, dout):
        dy, dg1, dg2 = combine_rows_backward(dout.contiguous(),
                                             *ctx.saved_tensors)
        return dy, dg1, dg2, None, None, None


def combine_rows(y: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor,
                 dest1: torch.Tensor, dest2: torch.Tensor,
                 slot_tok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[T, M] tokens in y's dtype from the expert outputs y [S, M] (K14 on
    the card). y, g1 or g2 that requires grad needs the routing's
    slot_tok (K17 the backward)."""
    if _needs_grad(y, g1, g2):
        if slot_tok is None:
            raise ValueError("the combine's backward (K17) reads slot_tok: "
                             "pass it with inputs that require grad")
        return _CombineRows.apply(y, g1, g2, dest1, dest2, slot_tok)
    return _combine_rows(y, g1, g2, dest1, dest2)


def combine_rows_backward(dout: torch.Tensor, y: torch.Tensor,
                          g1: torch.Tensor, g2: torch.Tensor,
                          dest1: torch.Tensor, dest2: torch.Tensor,
                          slot_tok: torch.Tensor):
    """(dy [S, M], dg1, dg2 [T] f32) of the combine's output gradient dout
    [T, M] in y's dtype (K17 on the card: one launch)."""
    if not _on_card(dout, y, g1, g2, dest1, dest2, slot_tok):
        return combine_rows_backward_reference(dout, y, g1, g2, dest1, dest2,
                                               slot_tok)
    _rows("combine backward", y)
    _rows("combine backward", dout)
    T, (S, M) = dest1.shape[0], y.shape
    if dout.shape != (T, M) or dout.dtype != y.dtype:
        raise ValueError(f"combine backward takes dout [{T}, {M}] "
                         f"{y.dtype}, got {dout.dtype} {tuple(dout.shape)}")
    for name, t, n, dtype in (("g1", g1, T, torch.float32),
                              ("g2", g2, T, torch.float32),
                              ("dest1", dest1, T, torch.int32),
                              ("dest2", dest2, T, torch.int32),
                              ("slot_tok", slot_tok, S, torch.int32)):
        _index(name, t, n, dtype)
    dy = torch.empty_like(y)
    dg1 = torch.empty(T, dtype=torch.float32, device=y.device)
    dg2 = torch.empty_like(dg1)
    with torch.cuda.device(y.device):
        rc = _kernel_fns()[3](
            _DTYPES[y.dtype], dout.data_ptr(), y.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), dest1.data_ptr(), dest2.data_ptr(),
            slot_tok.data_ptr(), dy.data_ptr(), dg1.data_ptr(),
            dg2.data_ptr(), T, S, M, _stream(y))
    _launched(rc, "combine backward", y.shape)
    combine_rows_backward.launches += 1
    return dy, dg1, dg2


route.launches = 0
gather_rows.launches = 0
combine_rows.launches = 0
gather_rows_backward.launches = 0
combine_rows_backward.launches = 0
route_backward.launches = 0


def combine_add_rms_norm(x: torch.Tensor, c: Combine, weight: torch.Tensor,
                         *, eps: float = 1e-6):
    """(r, y) of ``add_rms_norm(x, c.materialize(), weight)``: a MoE
    layer's output added to the residual stream x, whose rows are its
    tokens, and the sum's RMSNorm. On the card up to ROWS_MAX rows, one
    launch of K10's combine mode (``ops/norms.py::add_rms_norm_combine``),
    bitwise K14 then K10; above it K14 then K10. CPU tensors: the plain
    combine, then the add + norm."""
    if x.device.type == "cuda" and x.numel() // x.shape[-1] <= ROWS_MAX:
        r, y, _ = add_rms_norm_combine(x, *c, weight, eps=eps)
        return r, y
    return add_rms_norm(x, c.materialize().view(x.shape), weight, eps=eps)

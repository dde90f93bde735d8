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

CUDA tensors launch ``ops/csrc/moe.cu`` (built at first use by
``ops/_build.py``) or raise; CPU tensors take the plain versions. Each
launch adds one to ``route.launches``, ``gather_rows.launches`` or
``combine_rows.launches`` (K10's combine mode counts in
``ops/norms.py``'s ``add_rms_norm.combine_launches``). No kernel reads a
device value on the host, so a CUDA graph captures them. They have no
backward yet (the training slice): on the card an input that requires
grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
    [S]; :meth:`materialize` gives the expert buffers [S, M] (K13)."""

    x: torch.Tensor
    slot_tok: torch.Tensor
    slot_valid: torch.Tensor

    def materialize(self) -> torch.Tensor:
        return gather_rows(*self)


class Combine(NamedTuple):
    """K14's inputs with its launch left to the caller: the expert outputs
    ``y`` [S, M] and the routing's ``g1``, ``g2``, ``dest1``, ``dest2``
    [T]. :func:`combine_add_rms_norm` adds its rows to the residual
    stream; :meth:`materialize` gives them as [T, M] (K14)."""

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
    choice is e), taken before the capacity mask."""
    lg = logits.float()
    G, g, E = lg.shape
    m = lg.amax(dim=-1, keepdim=True)
    ex = torch.exp(lg - m)
    gates = ex / _serial_sum(ex)[..., None]
    experts = torch.arange(E, device=lg.device)
    e1 = _first_argmax(gates)
    mask1 = (e1[..., None] == experts).long()       # one-hot, no host sync
    e2 = _first_argmax(gates * (1 - mask1))
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


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


def _on_card(*ts: torch.Tensor) -> bool:
    devices = {t.device for t in ts}
    if len(devices) != 1 or next(iter(devices)).type not in ("cuda", "cpu"):
        raise ValueError(f"MoE dispatch ops run on one cuda device (kernels) "
                         f"or on the cpu (plain versions), got {devices}")
    if next(iter(devices)).type != "cuda":
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the MoE dispatch kernels have no backward yet (the training "
            "slice, ROADMAP Queue 1 item 6c)")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(rc: int, what: str, shape) -> None:
    if rc != 0:
        raise RuntimeError(f"MoE {what} launch failed: CUDA error {rc} "
                           f"({tuple(shape)})")


def route(logits: torch.Tensor, groups: int, capacity: int,
          slot_dtype: torch.dtype) -> Routing:
    """Top-2 routing of logits [T, E] (f32 or bf16; the routing is f32)
    in ``groups`` groups of ``capacity`` slots an expert (K12 on the card:
    one launch, a warp a group of up to 32 tokens, else a block or a
    cluster of blocks a group, about 512 tokens a block)."""
    T, E = logits.shape
    if groups < 1 or T % groups or capacity < 1 or E < 2:
        raise ValueError(f"route takes T ({T}) a multiple of groups "
                         f"({groups}), capacity >= 1 ({capacity}) and at "
                         f"least 2 experts ({E})")
    if not _on_card(logits):
        return route_reference(logits, groups, capacity, slot_dtype)
    S = E * groups * capacity
    if logits.dtype not in _DTYPES or not logits.is_contiguous() \
            or E > MAX_EXPERTS or slot_dtype not in _DTYPES \
            or S >= 2 ** 31 or T >= 2 ** 31 \
            or T // groups > MAX_GROUP_TOKENS:
        raise ValueError(f"route kernel takes contiguous f32 or bf16 logits "
                         f"[T, E] with E <= {MAX_EXPERTS}, groups of at most "
                         f"{MAX_GROUP_TOKENS} tokens, fewer than 2^31 "
                         f"slots and a bf16 or f32 slot dtype; got "
                         f"{logits.dtype} "
                         f"{tuple(logits.shape)} stride {logits.stride()}, "
                         f"{groups} groups, {S} slots, {slot_dtype}")
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


def gather_rows(x: torch.Tensor, slot_tok: torch.Tensor,
                slot_valid: torch.Tensor) -> torch.Tensor:
    """The expert buffers [S, M] of tokens x [T, M] (K13 on the card)."""
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


def combine_rows(y: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor,
                 dest1: torch.Tensor, dest2: torch.Tensor) -> torch.Tensor:
    """[T, M] tokens in y's dtype from the expert outputs y [S, M] (K14 on
    the card)."""
    if not _on_card(y, g1, g2, dest1, dest2):
        return combine_rows_reference(y, g1, g2, dest1, dest2)
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
    combine_rows.launches += 1
    return out


route.launches = 0
gather_rows.launches = 0
combine_rows.launches = 0


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

"""adafactor's update over every parameter: the CUDA kernel (K11) and its
plain PyTorch version.

The function is the JAX trainer's adafactor (``optax.adafactor`` with
``weight_decay_rate=weight_decay or None`` behind the global-norm clip,
all in f32 under ``_f32_moments``), in optax 0.2.6's order:

- g is the clipped gradient: ``(g / norm) * max_norm`` when the global
  norm (K5's, ``ops/optimizer.py::global_norm``) reaches ``max_norm``;
- factored tensors (the JAX leaf's two largest axes d0, d1 reach 128):
  ``v_row = decay v_row + keep mean_d0(g^2 + 1e-30)``, ``v_col`` the same
  over d1, ``u = (g * (v_row / mean_d1 v_row)^-1/2) * v_col^-1/2``; the
  others ``v = decay v + keep (g^2 + 1e-30)``, ``u = g * v^-1/2``, with
  ``decay = 1 - (count + 1)^-0.8`` in f32 and ``keep = 1 - decay``;
- per block (one JAX leaf: stacked over the layers when the tree is
  scanned, so one RMS spans every layer): ``u = u / max(1, rms(u))``,
  ``u = lr u``, ``u = u * max(1e-3, rms(p))``, ``u = u + wd p``;
- ``p = round_to_dtype(p - u)``.

The weight decay is added AFTER the learning rate: every step multiplies
each weight by ``1 - wd`` whatever the learning rate, even at lr = 0.
That is the reference's behaviour (ROADMAP.md Queue 3), mirrored here.

Which axes factor, and what a block is, follow the JAX leaf, not the
port's tensor: ``models/layout.py::JaxLeaf`` gives each parameter its
leaf, per-layer shape and the view of its ``[out, in]`` weight in that
shape. The state holds each parameter's moments in those per-layer JAX
shapes (stacked over the layers they are optax's ``FactoredState``
leaves): ``v_row`` and ``v_col`` for factored ones, ``v`` for the others
(a view, in the JAX shape, of memory laid out as the parameter).

The update dispatches on where the tensors live:

- CUDA tensors launch ``ops/csrc/adafactor.cu`` (six kernels a call,
  whatever the number of tensors), built at first use by
  ``ops/_build.py``, or raise: params contiguous bf16 or f32, grads the
  same, moments f32, every pointer 16-byte aligned. The kernels read a
  device table of the tensors, their strides and blocks, built once for a
  parameter set (``update.table_builds``), and an array of the gradients'
  pointers.
- CPU tensors take :func:`update_reference`, which the card also holds
  the kernel against: moments within 1e-6 relative of the plain version
  in f64, params within one bf16 ulp of it in f32 (the sums are taken in
  another order; given the same sums the two agree bitwise).

``update.launches`` counts the kernel calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from kubeflow_tpu_torch.models.layout import JaxLeaf
from kubeflow_tpu_torch.ops.optimizer import _f32, _on_card, _remember, _stream

_SOURCE = "adafactor.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-30                 # optax.adafactor's eps
DECAY_RATE = 0.8            # its decay_rate: decay = 1 - (count + 1)^-0.8
MIN_SCALE = 1e-3            # scale_by_param_block_rms's min_scale
#: The kernel's tile: TILE_F fast-axis elements by TILE_S slow-axis rows
#: (an unfactored tensor's tile: TILE_F * TILE_S contiguous elements).
TILE_F, TILE_S = 256, 64
_ENTRIES = 256      # moment entries a block of the kernel's pass (b)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """One step's scalars: the global clip, the update count before this
    step, the learning rate and the weight decay (0: none, as
    ``weight_decay or None`` in the JAX trainer)."""

    max_norm: float
    count: int
    lr: float
    weight_decay: float = 0.0

    def scalars(self):
        """(max_norm, decay, keep, lr, wd) as the f32 values both versions
        use; decay = 1 - t^-0.8 with t = count + 1, in f32."""
        t = np.float32(self.count + 1)
        decay = np.float32(1) - t ** np.float32(-DECAY_RATE)
        return (_f32(self.max_norm), float(decay),
                float(np.float32(1) - decay), _f32(self.lr),
                _f32(self.weight_decay))


def default_leaves(params: Dict[str, torch.Tensor]) -> Dict[str, JaxLeaf]:
    """Each parameter its own leaf, in its own shape (optax on a flat dict
    of the same arrays)."""
    return {n: JaxLeaf(n, tuple(p.shape)) for n, p in params.items()}


def _without(shape, axis: int):
    return tuple(s for i, s in enumerate(shape) if i != axis)


def init_state(params: Dict[str, torch.Tensor],
               leaves: Dict[str, JaxLeaf]) -> dict:
    """Zero moments in the per-layer JAX shapes: v_row (the leaf's shape
    without d0) and v_col (without d1) for factored tensors, v for the
    others, all f32 on the parameters' devices."""
    v_row, v_col, v = {}, {}, {}
    for n, p in params.items():
        leaf = leaves[n]
        dims = leaf.factored_dims()
        if dims is None:
            v[n] = leaf.view(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))
        else:
            d1, d0 = dims
            v_row[n] = torch.zeros(_without(leaf.shape, d0),
                                   dtype=torch.float32, device=p.device)
            v_col[n] = torch.zeros(_without(leaf.shape, d1),
                                   dtype=torch.float32, device=p.device)
    return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}


def blocks(names, leaves: Dict[str, JaxLeaf]) -> "OrderedDict[str, list]":
    """Parameter names grouped by JAX leaf, leaves in order of first
    appearance."""
    out: "OrderedDict[str, list]" = OrderedDict()
    for n in names:
        out.setdefault(leaves[n].path, []).append(n)
    return out


def update_reference(params: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor], state: dict,
                     leaves: Dict[str, JaxLeaf], norm: torch.Tensor,
                     hyper: Hyper, dtype: torch.dtype = torch.float32
                     ) -> None:
    """The update of :func:`update` in plain PyTorch, leaf by leaf, in
    place on ``params`` and the state's moments. ``dtype`` is the
    arithmetic's: f32 (the function; the card's checks hold the kernel's
    params to it), or f64 for moments rounded once from exact-enough sums
    (the card's checks hold the kernel's moments to those)."""
    max_norm, decay, keep, lr, wd = hyper.scalars()
    norm = norm.to(dtype)
    clip = norm >= max_norm
    for names in blocks(params, leaves).values():
        us = []
        for n in names:
            leaf = leaves[n]
            g = grads[n].to(dtype).contiguous()
            g = leaf.view(torch.where(clip, g / norm * max_norm, g))
            sq = g * g + EPS
            dims = leaf.factored_dims()
            if dims is None:
                v = decay * state["v"][n].to(dtype) + keep * sq
                state["v"][n].copy_(v)
                us.append(g * v.sqrt().reciprocal())
                continue
            d1, d0 = dims
            vr = decay * state["v_row"][n].to(dtype) + keep * sq.mean(d0)
            vc = decay * state["v_col"][n].to(dtype) + keep * sq.mean(d1)
            state["v_row"][n].copy_(vr)
            state["v_col"][n].copy_(vc)
            rcm = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            row = (vr / rcm).sqrt().reciprocal().unsqueeze(d0)
            col = vc.sqrt().reciprocal().unsqueeze(d1)
            us.append(g * row * col)
        count = float(np.float32(sum(u.numel() for u in us)))
        ps = [leaves[n].view(params[n].to(dtype).contiguous())
              for n in names]
        su = torch.stack([(u * u).sum() for u in us]).sum()
        sp = torch.stack([(p * p).sum() for p in ps]).sum()
        denom = torch.clamp_min((su / count).sqrt(), 1.0)
        rms_p = (sp / count).sqrt()
        scale = torch.where(rms_p <= MIN_SCALE,
                            torch.full_like(rms_p, MIN_SCALE), rms_p)
        for n, u, p in zip(names, us, ps):
            u = lr * (u / denom)
            u = u * scale
            if wd:
                u = u + wd * p
            leaves[n].view(params[n]).copy_(p - u)


def bind(lib: ctypes.CDLL):
    """K11's C entry point with its signature."""
    fn = lib.kftpu_adafactor_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    return fn


#: The device table's int64 fields a tensor, in the kernel's order.
FIELDS = ("p", "v", "vc", "numel", "first", "first_entry", "first_slice",
          "flags", "nF", "sF", "nS", "sS", "tilesF", "tilesS", "nA", "sA",
          "nB", "sB", "rA", "rB", "r1", "cA", "cB", "c0", "pf", "ps", "rf",
          "cf", "leaf")
_FACTORED, _FAST_D0, _VEC = 1 << 4, 1 << 5, 1 << 6


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from kubeflow_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    lib.kftpu_adafactor_layout.restype = ctypes.c_longlong
    lib.kftpu_adafactor_layout.argtypes = [ctypes.c_int]
    got = tuple(lib.kftpu_adafactor_layout(i) for i in range(5))
    want = (TILE_F * TILE_S, TILE_F, TILE_S, len(FIELDS), 3)
    if got != want:
        raise RuntimeError(f"{_SOURCE}'s tile and table layout {got}, the "
                           f"wrapper's {want}")
    return bind(lib)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class _Plan:
    """The device tables and the scratch layout of one parameter set."""
    table: torch.Tensor
    leaves: torch.Tensor
    order: List[str]
    pairs: int              # bit (p | g << 2) for each dtype pair present
    tiles: int
    entry_blocks: int
    slices: int
    scratch: int            # f32 elements in all
    p2_at: int              # where the tiles' p^2 sums start
    u2_at: int              # the tiles' u^2 sums
    leaf_at: int            # the leaves' [denominator, scale]


def _row(name, p, g, leaf: JaxLeaf, state, dev) -> dict:
    """One tensor's table fields but its places in the grids and the
    scratch (filled by the caller); checks what the kernel takes."""
    if p.device != dev or not p.is_contiguous() or p.dtype not in _DTYPES \
            or p.data_ptr() % 16:
        raise ValueError(f"adafactor kernel takes contiguous, 16-byte "
                         f"aligned bf16 or f32 params on {dev}; {name} is "
                         f"{tuple(p.shape)} {p.dtype} on {p.device}")
    f = dict.fromkeys(FIELDS, 0)
    f.update(p=p.data_ptr(), numel=p.numel(), nA=1, nB=1)
    dtypes = _DTYPES[p.dtype] | _DTYPES[g.dtype] << 2
    dims = leaf.factored_dims()
    jv = leaf.view(p)
    if dims is None:
        v = state["v"][name]
        if v.device != dev or v.dtype != torch.float32 \
                or v.stride() != jv.stride() or v.data_ptr() % 16:
            raise ValueError(f"adafactor kernel takes v f32, 16-byte "
                             f"aligned and laid out as its parameter; "
                             f"{name}'s is {v.dtype}, strides "
                             f"{v.stride()} against {jv.stride()}")
        f.update(v=v.data_ptr(), flags=dtypes | _VEC)
        return f
    d1, d0 = dims
    vr, vc = state["v_row"][name], state["v_col"][name]
    for m in (vr, vc):
        if m.device != dev or m.dtype != torch.float32:
            raise ValueError(f"adafactor kernel takes f32 moments on {dev}; "
                             f"{name}'s are {m.dtype} on {m.device}")
    st = jv.stride()
    fast, slow = (d0, d1) if st[d0] <= st[d1] else (d1, d0)
    batch = [a for a in range(len(leaf.shape)) if a not in (d0, d1)]
    if len(batch) > 2:
        raise ValueError(f"adafactor kernel takes at most two batch axes; "
                         f"{name}'s leaf shape {leaf.shape} has {len(batch)}")
    nF, nS = leaf.shape[fast], leaf.shape[slow]
    vec = st[fast] == 1 and nF % 8 == 0 and all(
        st[a] % 8 == 0 for a in [slow] + batch)
    f.update(v=vr.data_ptr(), vc=vc.data_ptr(),
             flags=(dtypes | _FACTORED | (_FAST_D0 if fast == d0 else 0)
                    | (_VEC if vec else 0)),
             nF=nF, sF=st[fast], nS=nS, sS=st[slow],
             tilesF=_cdiv(nF, TILE_F), tilesS=_cdiv(nS, TILE_S),
             r1=vr.stride(d1 - (d1 > d0)), c0=vc.stride(d0 - (d0 > d1)))
    # Up to two batch axes (A, B): sizes and strides in p, v_row, v_col.
    for (n_, s_, r_, c_), a in zip((("nA", "sA", "rA", "cA"),
                                    ("nB", "sB", "rB", "cB")),
                                   [None] * (2 - len(batch)) + batch):
        if a is not None:
            f.update({n_: leaf.shape[a], s_: st[a],
                      r_: vr.stride(a - (a > d0)),
                      c_: vc.stride(a - (a > d1))})
    return f


def _plan(params, grads, state, leaves, dev) -> _Plan:
    names = blocks(params, leaves)
    order = [n for group in names.values() for n in group
             if params[n].numel()]
    rows = [_row(n, params[n], grads[n], leaves[n], state, dev)
            for n in order]
    tile = entry = slices = part = 0
    leaf_rows, leaf_of = [], {}
    for n, f in zip(order, rows):
        path = leaves[n].path
        if path not in leaf_of:
            leaf_of[path] = len(leaf_rows)
            leaf_rows.append([tile, 0, 0])
        f.update(first=tile, first_entry=entry, first_slice=slices,
                 leaf=leaf_of[path])
        if f["flags"] & _FACTORED:
            B = f["nA"] * f["nB"]
            n0, n1 = ((f["nF"], f["nS"]) if f["flags"] & _FAST_D0
                      else (f["nS"], f["nF"]))
            f["pf"] = part
            f["ps"] = f["pf"] + B * f["tilesS"] * f["nF"]
            f["rf"] = f["ps"] + B * f["tilesF"] * f["nS"]
            f["cf"] = f["rf"] + B * n1
            part = f["cf"] + B * n0
            entry += _cdiv(B * (f["nF"] + f["nS"]), _ENTRIES)
            slices += B
            tiles = B * f["tilesF"] * f["tilesS"]
        else:
            tiles = _cdiv(f["numel"], TILE_F * TILE_S)
        tile += tiles
        leaf_rows[leaf_of[path]][1] += tiles
        leaf_rows[leaf_of[path]][2] += f["numel"]
    update.table_builds += 1
    table = torch.tensor([[f[k] for k in FIELDS] for f in rows],
                         dtype=torch.int64).to(dev)
    leaf_table = torch.tensor(leaf_rows, dtype=torch.int64).to(dev)
    pairs = 0
    for f in rows:
        pairs |= 1 << (f["flags"] & 15)
    return _Plan(table, leaf_table, order, pairs, tile, entry, slices,
                 part + 2 * tile + 2 * len(leaf_rows), part, part + tile,
                 part + 2 * tile)


_plans: "OrderedDict[tuple, _Plan]" = OrderedDict()
_grad_ptrs: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           state: dict, leaves: Dict[str, JaxLeaf], norm: torch.Tensor,
           hyper: Hyper) -> None:
    """One adafactor step over every parameter, in place (see
    :func:`update_reference` for the arithmetic); ``state``'s moments are
    updated in place too, its count is the caller's."""
    if not params:
        return
    moments = [t for k in ("v_row", "v_col", "v") for t in state[k].values()]
    if not _on_card(list(params.values()) + list(grads.values()) + moments
                    + [norm]):
        update_reference(params, grads, state, leaves, norm, hyper)
        return
    dev = next(iter(params.values())).device
    for n, p in params.items():
        g = grads[n]
        if g.device != dev or not g.is_contiguous() or g.shape != p.shape \
                or g.dtype not in _DTYPES or g.data_ptr() % 16:
            raise ValueError(f"adafactor kernel takes contiguous, 16-byte "
                             f"aligned bf16 or f32 grads of the params' "
                             f"shapes on {dev}; {n}'s is {tuple(g.shape)} "
                             f"{g.dtype} on {g.device}")
    key = tuple((n, p.data_ptr(), p.dtype, grads[n].dtype, tuple(p.shape))
                for n, p in params.items()) + tuple(
        t.data_ptr() for t in moments)
    plan = _remember(_plans, key,
                     lambda: _plan(params, grads, state, leaves, dev))
    ptrs = tuple(grads[n].data_ptr() for n in plan.order)
    gptrs = _remember(_grad_ptrs, (dev,) + ptrs, lambda: torch.tensor(
        ptrs, dtype=torch.int64).pin_memory().to(dev, non_blocking=True))
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    norm = norm.reshape(1).float().contiguous()
    with torch.cuda.device(dev):
        rc = _kernel_fn()(plan.table.data_ptr(), plan.leaves.data_ptr(),
                          gptrs.data_ptr(), len(plan.order),
                          plan.leaves.shape[0], plan.pairs, plan.tiles,
                          plan.entry_blocks, plan.slices, scratch.data_ptr(),
                          plan.p2_at, plan.u2_at, plan.leaf_at,
                          norm.data_ptr(), *hyper.scalars(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"adafactor launch failed: CUDA error {rc} "
                           f"({len(plan.order)} tensors, {plan.tiles} tiles)")
    update.launches += 1


update.launches = 0
update.table_builds = 0

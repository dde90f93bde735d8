"""The optimizer step over every parameter: the CUDA kernel (K5) and its
plain PyTorch version.

Two calls make a step. :func:`global_norm` is the f32 norm of every
gradient: a sum of squares per chunk of :data:`CHUNK` elements (the chunk
table: each tensor cut into chunks, tensor by tensor), then one sum of
the chunks' partials in chunk order, so two calls agree bitwise.
:func:`update` then clips by that norm (a device scalar: no host read)
and applies adamw, lion or sgd (nesterov trace) with decoupled weight
decay, in place, with optax's arithmetic as the port's trainer states it
(``train/trainer.py``); :class:`Hyper` holds the host's f32 scalars. They
dispatch on where the tensors live:

- CUDA tensors launch ``ops/csrc/optimizer.cu``, built at first use by
  ``ops/_build.py``, or raise: every tensor contiguous and 16-byte
  aligned, params, grads and mu bf16 or f32, nu (and sgd's trace) f32.
  One launch for the norm (partials and their sum) and one for the
  update, whatever the number of tensors. The kernels read a device table
  of the parameters' and moments' pointers, sizes and dtypes, built once
  for a parameter set (``update.table_builds`` counts the builds), and an
  array of the gradients' pointers, uploaded when they change.
- CPU tensors take the plain versions (:func:`global_norm_reference`,
  :func:`update_reference`), which are also what the card holds the
  kernel against; given the same norm, kernel and plain update agree
  bitwise.

``global_norm.launches`` and ``update.launches`` count the kernel calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

_SOURCE = "optimizer.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Elements a chunk of the table holds (the kernel's kChunk).
CHUNK = 65536
KINDS = {"adamw": 0, "lion": 1, "sgd": 2}
_FIELDS = 6          # int64 fields a tensor in the device table
_TABLES_KEPT = 4


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Hyper:
    """One step's scalars: the clip threshold, the moment decays, the bias
    corrections 1 - b^t (adamw), the decoupled weight decay and the
    learning rate. :meth:`scalars` gives the f32 values both versions use:
    1 - b1 and 1 - b2 as the host computes them, and the bias corrections
    as f32 reciprocals (a division by a scalar is a product with its
    reciprocal, as PyTorch's CUDA division computes it)."""

    max_norm: float
    b1: float
    b2: float
    bc1: float = 1.0
    bc2: float = 1.0
    weight_decay: float = 0.0
    lr: float = 0.0
    eps: float = 1e-8

    def scalars(self):
        inv = lambda x: float(np.float32(1.0) / np.float32(x))  # noqa: E731
        return tuple(_f32(v) for v in (
            self.max_norm, 1 - self.b1, self.b1, 1 - self.b2, self.b2,
            inv(self.bc1), inv(self.bc2), self.eps, self.weight_decay,
            -self.lr))


def chunks_of(numel: int) -> int:
    return -(-numel // CHUNK)


def global_norm_reference(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of g^2 in f32: per chunk of the table, then the
    partials summed in chunk order."""
    partials = []
    for g in grads:
        flat = g.float().reshape(-1)
        full = flat.numel() // CHUNK * CHUNK
        if full:
            partials.append(flat[:full].view(-1, CHUNK).square().sum(1))
        if flat.numel() > full:
            partials.append(flat[full:].square().sum()[None])
    if not partials:
        return torch.zeros((), device=grads[0].device if grads else None)
    return torch.cat(partials).sum().sqrt()


def update_reference(kind: str, params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     moments: Sequence[torch.Tensor],
                     second: Optional[Sequence[torch.Tensor]],
                     norm: torch.Tensor, hyper: Hyper) -> None:
    """The update of :func:`update` in plain PyTorch, tensor by tensor, in
    place: ``moments`` are adamw's and lion's mu (any float dtype) or sgd's
    trace (f32), ``second`` adamw's nu (f32)."""
    max_norm, c1, b1, c2, b2, ib1, ib2, eps, wd, neg_lr = hyper.scalars()
    clip = norm >= max_norm
    for i, p in enumerate(params):
        g = grads[i].float()
        g = torch.where(clip, g / norm * max_norm, g)
        p32 = p.float()
        m = moments[i]
        if kind == "adamw":
            mu = c1 * g + b1 * m
            nu = second[i]
            nu.mul_(b2).add_(c2 * g.square())
            u = (mu * ib1) / ((nu * ib2).sqrt() + eps)
            m.copy_(mu)
        elif kind == "lion":
            u = torch.sign(c1 * g + b1 * m)
            m.copy_(c2 * g + b2 * m)
        else:
            m.copy_(g + b1 * m)
            u = g + b1 * m
        u = (u + wd * p32) * neg_lr
        p.copy_(p32 + u)


def bind(lib: ctypes.CDLL):
    """K5's C entry points (norm, update) with their signatures."""
    norm = lib.kftpu_global_norm
    norm.restype = ctypes.c_int
    norm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p]
    upd = lib.kftpu_optimizer_update
    upd.restype = ctypes.c_int
    upd.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
                    + [ctypes.c_float] * 10 + [ctypes.c_void_p])
    return norm, upd


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    lib.kftpu_optimizer_chunk.restype = ctypes.c_longlong
    if lib.kftpu_optimizer_chunk() != CHUNK:
        raise RuntimeError(f"{_SOURCE} cuts tensors into chunks of "
                           f"{lib.kftpu_optimizer_chunk()}, the wrapper's "
                           f"table into {CHUNK}")
    return bind(lib)


def _on_card(tensors: Sequence[torch.Tensor]) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"the optimizer runs on cuda (kernel) or cpu (plain "
                     f"version), with every tensor on one; got {kinds}")


_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_grad_ptrs: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def _remember(cache: OrderedDict, key: tuple, make):
    """cache[key], made by ``make()`` on a miss; the last few are kept."""
    value = cache.get(key)
    if value is None:
        value = cache[key] = make()
        while len(cache) > _TABLES_KEPT:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return value


def _table(columns: List[Sequence[Optional[torch.Tensor]]]):
    """(device table, device gradient pointers, tensors, chunks) over rows
    of (p, g, mu, nu), p, mu and nu possibly None. The table (pointers of
    p, mu and nu, sizes, first chunks, dtypes) is built once for a set of
    them; the gradients' pointers, new tensors each step, are uploaded
    when they change."""
    rows = list(zip(*columns))
    dev = rows[0][1].device
    key, sizes = [], []
    for row in rows:
        n = row[1].numel()
        for j, t in enumerate(row):
            if t is None:
                continue
            if t.device != dev or not t.is_contiguous() or t.numel() != n \
                    or t.data_ptr() % 16 or t.dtype not in _DTYPES \
                    or (j == 3 and t.dtype != torch.float32):
                raise ValueError(
                    f"optimizer kernel takes contiguous, 16-byte aligned "
                    f"bf16 or f32 tensors of one size on {dev} (nu f32); got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device} beside "
                    f"{n} elements")
        sizes.append(n)
        key.append(tuple((0, 0) if t is None else
                         (0 if j == 1 else t.data_ptr(), _DTYPES[t.dtype])
                         for j, t in enumerate(row)) + (n,))

    def build():
        host = np.zeros((len(rows), _FIELDS), np.int64)
        first = 0
        for i, (row, n) in enumerate(zip(rows, sizes)):
            for field, t in ((0, row[0]), (1, row[2]), (2, row[3])):
                if t is not None:
                    host[i, field] = t.data_ptr()
            host[i, 3], host[i, 4] = n, first
            host[i, 5] = sum(_DTYPES[t.dtype] << (2 * j)
                             for j, t in enumerate(row[:3]) if t is not None)
            first += chunks_of(n)
        update.table_builds += 1
        return torch.from_numpy(host).to(dev)

    table = _remember(_tables, tuple(key), build)
    ptrs = tuple(row[1].data_ptr() for row in rows)
    grads = _remember(_grad_ptrs, (dev,) + ptrs, lambda: torch.tensor(
        ptrs, dtype=torch.int64).pin_memory().to(dev, non_blocking=True))
    return table, grads, len(rows), sum(chunks_of(n) for n in sizes)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    global_norm), as a 0-dim device tensor."""
    grads = list(grads)
    if not grads or not _on_card(grads):
        return global_norm_reference(grads)
    none = [None] * len(grads)
    table, gptrs, T, chunks = _table([none, grads, none, none])
    dev = grads[0].device
    norm = torch.empty(1, dtype=torch.float32, device=dev)
    if chunks == 0:
        return norm.zero_()[0]
    partial = torch.empty(chunks, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel_fns()[0](table.data_ptr(), gptrs.data_ptr(), T, chunks,
                              partial.data_ptr(), norm.data_ptr(),
                              _stream(dev))
    if rc != 0:
        raise RuntimeError(f"global_norm launch failed: CUDA error {rc} "
                           f"({T} tensors, {chunks} chunks)")
    global_norm.launches += 1
    return norm[0]


def update(kind: str, params: Sequence[torch.Tensor],
           grads: Sequence[torch.Tensor], moments: Sequence[torch.Tensor],
           second: Optional[Sequence[torch.Tensor]], norm: torch.Tensor,
           hyper: Hyper) -> None:
    """One step of ``kind`` (adamw | lion | sgd) over every tensor, in
    place (see :func:`update_reference` for the arithmetic)."""
    if kind not in KINDS:
        raise ValueError(f"unknown optimizer {kind!r} ({' | '.join(KINDS)})")
    if (second is not None) != (kind == "adamw"):
        raise ValueError("adamw takes the second moment; lion and sgd not")
    params = list(params)
    if not params:
        return
    cols = [params, list(grads), list(moments),
            list(second) if second is not None else [None] * len(params)]
    if not _on_card([t for c in cols for t in c if t is not None] + [norm]):
        update_reference(kind, *cols[:3], second, norm, hyper)
        return
    if kind == "sgd" and any(m.dtype != torch.float32 for m in cols[2]):
        raise ValueError("sgd's trace is f32")
    table, gptrs, T, chunks = _table(cols)
    dev = params[0].device
    norm = norm.reshape(1).float().contiguous()
    if chunks == 0:
        return
    with torch.cuda.device(dev):
        rc = _kernel_fns()[1](KINDS[kind], table.data_ptr(),
                              gptrs.data_ptr(), T, chunks, norm.data_ptr(),
                              *hyper.scalars(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"optimizer update launch failed: CUDA error {rc} "
                           f"({T} tensors, {chunks} chunks)")
    update.launches += 1


global_norm.launches = 0
update.launches = 0
update.table_builds = 0

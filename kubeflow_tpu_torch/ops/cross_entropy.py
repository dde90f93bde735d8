"""The language-model cross-entropy over [N, V] logits: the CUDA kernel (K8)
and its plain PyTorch version.

:func:`cross_entropy_sums` returns (sum of w nll, sum of w, sum of w hit)
over the rows, where nll carries the z-loss and label-smoothing terms of
``kubeflow_tpu.train.losses.cross_entropy_loss`` and hit is the argmax
(lowest index on ties) equal to the label. It is a
``torch.autograd.Function`` that saves only the row ``logz`` [N] f32
besides its inputs; its backward is written out from the formula
(:func:`cross_entropy_backward_reference`). It dispatches on where the
logits live:

- CUDA tensors launch ``ops/csrc/cross_entropy.cu``, built at first use by
  ``ops/_build.py``, or raise: logits bf16 or f32, contiguous, 16-byte
  aligned, V a multiple of 8; labels int64 [N]; weights f32 [N] or None.
  The forward reads the logits once (an online logsumexp, the argmax and
  the row terms, then a fixed-order sum of the rows: two kernels, one
  call), the backward reads them once and writes dlogits once, in the
  logits' dtype. No f32 copy of the logits is made.
- CPU tensors take the plain pair, which is also what the card holds the
  kernel against.

Each forward call adds one to ``cross_entropy_sums.fwd_launches``, each
backward call to ``cross_entropy_sums.bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_SOURCE = "cross_entropy.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def cross_entropy_reference(
    logits: torch.Tensor, labels: torch.Tensor,
    weights: Optional[torch.Tensor], z_loss_weight: float,
    label_smoothing: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums [3] f32, logz [N] f32) in plain PyTorch: logits [N, V] in f32,
    labels [N], weights [N] or None (all 1)."""
    x = logits.float()
    V = x.shape[-1]
    logz = torch.logsumexp(x, dim=-1)
    nll = logz - torch.gather(x, -1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        nll = ((1.0 - label_smoothing) * nll
               + label_smoothing * (logz - x.sum(-1) / V))
    if z_loss_weight > 0.0:
        nll = nll + z_loss_weight * logz.square()
    hit = (x.argmax(-1) == labels).float()
    w = torch.ones_like(nll) if weights is None else weights.float()
    sums = torch.stack([(nll * w).sum(), w.sum(), (hit * w).sum()])
    return sums, logz


def cross_entropy_backward_reference(
    logits: torch.Tensor, labels: torch.Tensor,
    weights: Optional[torch.Tensor], logz: torch.Tensor, g: torch.Tensor,
    z_loss_weight: float, label_smoothing: float,
) -> torch.Tensor:
    """dlogits of sums[0] with cotangent g, from the formula: g w (p (1 +
    2 zw logz) - ls / V - (1 - ls) onehot), p = exp(logits - logz), in the
    logits' dtype."""
    x = logits.float()
    V = x.shape[-1]
    p = torch.exp(x - logz[:, None])
    d = p * (1.0 + 2.0 * z_loss_weight * logz)[:, None] - label_smoothing / V
    d[torch.arange(x.shape[0], device=x.device), labels] -= \
        1.0 - label_smoothing
    w = torch.ones_like(logz) if weights is None else weights.float()
    return (d * (g.float() * w)[:, None]).to(logits.dtype)


def bind(lib: ctypes.CDLL):
    """K8's C entry points (forward, backward) with their signatures."""
    fwd = lib.kftpu_cross_entropy_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p])
    bwd = lib.kftpu_cross_entropy_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p])
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"cross_entropy_sums runs on cuda (kernel) or cpu "
                     f"(plain version), not {x.device}")


def _check(logits, labels, weights) -> None:
    if logits.dim() != 2 or logits.dtype not in _DTYPES \
            or logits.shape[0] == 0 or logits.shape[1] % 8:
        raise ValueError(f"cross_entropy kernel takes bf16 or f32 logits "
                         f"[N > 0, V] with V a multiple of 8, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if not logits.is_contiguous() or logits.data_ptr() % 16:
        raise ValueError("cross_entropy kernel takes contiguous, 16-byte "
                         "aligned logits")
    n = logits.shape[0]
    if labels.shape != (n,) or labels.dtype != torch.int64 \
            or labels.device != logits.device or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous int64 [{n}] on "
                         f"{logits.device}")
    if weights is not None and (
            weights.shape != (n,) or weights.dtype != torch.float32
            or weights.device != logits.device
            or not weights.is_contiguous()):
        raise ValueError(f"weights must be contiguous f32 [{n}] on "
                         f"{logits.device}")


def _fwd_kernel(logits, labels, weights, zw: float, ls: float):
    _check(logits, labels, weights)
    n, V = logits.shape
    dev = logits.device
    logz = torch.empty(n, dtype=torch.float32, device=dev)
    terms = torch.empty((n, 3), dtype=torch.float32, device=dev)
    sums = torch.empty(3, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fns()[0](
            _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
            0 if weights is None else weights.data_ptr(), logz.data_ptr(),
            terms.data_ptr(), sums.data_ptr(), n, V, float(zw), float(ls),
            stream)
    if rc != 0:
        raise RuntimeError(f"cross_entropy forward launch failed: CUDA error "
                           f"{rc} (logits {tuple(logits.shape)})")
    cross_entropy_sums.fwd_launches += 1
    return sums, logz


def _bwd_kernel(logits, labels, weights, logz, g, zw: float, ls: float):
    _check(logits, labels, weights)
    n, V = logits.shape
    dev = logits.device
    g = g.float().reshape(1).contiguous()
    dlogits = torch.empty_like(logits)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fns()[1](
            _DTYPES[logits.dtype], logits.data_ptr(), labels.data_ptr(),
            0 if weights is None else weights.data_ptr(), logz.data_ptr(),
            g.data_ptr(), dlogits.data_ptr(), n, V, float(zw), float(ls),
            stream)
    if rc != 0:
        raise RuntimeError(f"cross_entropy backward launch failed: CUDA "
                           f"error {rc} (logits {tuple(logits.shape)})")
    cross_entropy_sums.bwd_launches += 1
    return dlogits


class _CrossEntropy(torch.autograd.Function):
    """(s_nll, s_w, s_hit) of (logits, labels, weights); only s_nll has a
    gradient. Saves the logits, labels, weights and logz."""

    @staticmethod
    def forward(ctx, logits, labels, weights, zw, ls):
        if _on_card(logits):
            sums, logz = _fwd_kernel(logits, labels, weights, zw, ls)
        else:
            sums, logz = cross_entropy_reference(logits, labels, weights,
                                                 zw, ls)
        ctx.save_for_backward(logits, labels, weights, logz)
        ctx.zw, ctx.ls = zw, ls
        s_nll, s_w, s_hit = sums.unbind()
        ctx.mark_non_differentiable(s_w, s_hit)
        return s_nll, s_w, s_hit

    @staticmethod
    def backward(ctx, g, _gw, _gh):
        logits, labels, weights, logz = ctx.saved_tensors
        if _on_card(logits):
            d = _bwd_kernel(logits, labels, weights, logz, g, ctx.zw, ctx.ls)
        else:
            d = cross_entropy_backward_reference(logits, labels, weights,
                                                 logz, g, ctx.zw, ctx.ls)
        return d, None, None, None, None


def cross_entropy_sums(
    logits: torch.Tensor, labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None, *, z_loss_weight: float = 0.0,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum w nll, sum w, sum w hit) over logits [N, V] (any float dtype;
    statistics in f32), labels [N] and weights [N] (None: all 1)."""
    labels = labels.reshape(-1).long().contiguous()
    if weights is not None:
        weights = weights.reshape(-1).float().contiguous()
    return _CrossEntropy.apply(logits, labels, weights,
                               float(z_loss_weight), float(label_smoothing))


cross_entropy_sums.fwd_launches = 0
cross_entropy_sums.bwd_launches = 0

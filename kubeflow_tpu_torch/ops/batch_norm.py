"""BatchNorm with flax's semantics, with an optional residual add and ReLU
in the same call: the CUDA kernel (K19) and its plain PyTorch version.

flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, which the JAX ResNet
uses, is not torch's ``batch_norm``: the running statistics keep 0.9 of the
OLD value (torch's ``momentum=0.1`` is the new value's weight), the running
variance is the biased one, the variance is E[x^2] - E[x]^2 clipped at 0
(``use_fast_variance``), and y is formed in f32 as (x - mean) (rsqrt(var +
eps) scale) + bias and rounded once. The ResNet's bottleneck ends in
``relu(bn3(y) + residual)``: the add rounds the normalised bf16 y again.

:func:`batch_norm` takes the channels-last activation x [..., C] (the JAX
NHWC layout, contiguous), scale and bias [C] f32, and the running buffers
[C] f32, which a training call updates in place. It is a
``torch.autograd.Function`` that saves x, the output (for the ReLU mask)
and the statistics it used, with a backward written out from the formulas
(:func:`batch_norm_backward_reference`); the residual's gradient is the
masked incoming one. It dispatches on where x lives:

- CUDA tensors launch ``ops/csrc/batch_norm.cu``, built at first use by
  ``ops/_build.py``, or raise: x (and the residual, and the backward's
  gradient) bf16 or f32, contiguous in the channels-last layout (a
  tensor that is not raises; nothing is copied), 16-byte aligned;
  scale, bias and the buffers f32 [C]. A forward is one call of three
  kernels in training (per-block partial sums, their fixed-order sum,
  the apply) and one in eval; a backward one call of three. No atomics:
  two calls are bitwise equal.
- CPU tensors take the plain pair (:func:`batch_norm_reference`,
  :func:`batch_norm_backward_reference`), which is also what the card
  holds the kernel against.

Each forward call adds one to ``batch_norm.fwd_launches``, each backward
call to ``batch_norm.bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

_SOURCE = "batch_norm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: flax nn.BatchNorm's defaults as the JAX ResNet takes them; the kernel
#: has them as constants (batch_norm.cu's kOld, kNew, kEps).
MOMENTUM = 0.9
EPS = 1e-5
#: The running statistics' weights as JAX forms them: Python floats (1 -
#: momentum in double precision) that become f32 at the multiply.
_W_OLD, _W_NEW = float(np.float32(MOMENTUM)), float(np.float32(1.0 - MOMENTUM))
_THREADS = 256


def batch_norm_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    ra_mean: torch.Tensor, ra_var: torch.Tensor, *, train: bool,
    residual: Optional[torch.Tensor] = None, relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, mean, var) in plain PyTorch, the kernel's arithmetic in its
    order: training statistics over every dim but the last (f32), the
    running buffers updated in place from them (w_old ra + w_new stat),
    else the running ones; y = (x - mean) (rstd scale) + bias in f32,
    rounded to x's dtype; + residual (rounded again); ReLU."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    if train:
        n = xf.shape[0]
        mean = xf.sum(0) / n
        var = ((xf * xf).sum(0) / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            ra_mean.copy_(ra_mean * _W_OLD + mean * _W_NEW)
            ra_var.copy_(ra_var * _W_OLD + var * _W_NEW)
    else:
        mean, var = ra_mean.float().clone(), ra_var.float().clone()
    rstd = 1.0 / torch.sqrt(var + EPS)
    y = ((xf - mean) * (rstd * scale.float()) + bias.float()).to(x.dtype)
    if residual is not None:
        y = y + residual.reshape(-1, C)
    if relu:
        y = torch.relu(y)
    return y.reshape(x.shape), mean, var


def batch_norm_backward_reference(
    x: torch.Tensor, out: Optional[torch.Tensor], dy: torch.Tensor,
    mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor, *,
    train: bool, relu: bool, residual: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx, dscale, dbias, dresidual) of :func:`batch_norm_reference`, from
    the formulas: g = dy where out > 0 (ReLU; JAX's gradient at 0 is 0),
    xh = (x - mean) rstd, dbias = sum g, dscale = sum g xh (f32 [C]);
    training dx = rstd scale ((g - dbias / N) - xh dscale / N), eval
    dx = rstd scale g, in x's dtype; dresidual = g (None without one)."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    g = dy.reshape(-1, C).float()
    if relu:
        g = torch.where(out.reshape(-1, C) > 0, g, torch.zeros_like(g))
    rstd = 1.0 / torch.sqrt(var + EPS)
    xh = (xf - mean) * rstd
    dbias = g.sum(0)
    dscale = (g * xh).sum(0)
    k = rstd * scale.float()
    if train:
        n = xf.shape[0]
        dx = k * ((g - dbias / n) - xh * (dscale / n))
    else:
        dx = k * g
    dres = g.to(x.dtype).reshape(x.shape) if residual else None
    return dx.to(x.dtype).reshape(x.shape), dscale, dbias, dres


def bind(lib: ctypes.CDLL):
    """K19's C entry points (forward, backward) with their signatures."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = lib.kftpu_batch_norm_fwd
    fwd.restype = i
    fwd.argtypes = [i] * 3 + [p] * 10 + [ctypes.c_longlong, i, i, p]
    bwd = lib.kftpu_batch_norm_bwd
    bwd.restype = i
    bwd.argtypes = [i] * 3 + [p] * 12 + [ctypes.c_longlong, i, i, p]
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_blocks(rows: int, C: int, sms: int) -> int:
    """The row runs P the kernel's passes split x into: about eight blocks
    an SM over the channel tiles, each of whose row lanes takes 16 rows or
    more."""
    vec = 8 if C % 8 == 0 else 1
    width = min(C // vec, _THREADS)
    tiles = math.ceil(C // vec / _THREADS)
    lanes = _THREADS // width
    return max(1, min(rows, 65535, max(1, 8 * sms // tiles),
                      math.ceil(rows / (lanes * 16))))


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"batch_norm runs on cuda (kernel) or cpu (plain "
                     f"version), not {x.device}")


def _check_act(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A [..., C] activation the kernel reads as [rows, C]: like x's shape
    and dtype, contiguous (channels-last), 16-byte aligned."""
    if t.shape != like.shape or t.dtype != like.dtype \
            or t.device != like.device:
        raise ValueError(f"batch_norm kernel takes {name} like x "
                         f"{tuple(like.shape)} {like.dtype}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"batch_norm kernel takes a channels-last "
                         f"contiguous, 16-byte aligned {name} [..., C]; got "
                         f"strides {t.stride()} (it copies nothing)")


def _check(x, scale, bias, ra_mean, ra_var) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"batch_norm kernel takes bf16 or f32 x, got "
                         f"{x.dtype}")
    if x.numel() == 0:
        raise ValueError("batch_norm kernel takes a non-empty x")
    _check_act("x", x, x)
    C = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias), ("ra_mean", ra_mean),
                    ("ra_var", ra_var)):
        if t.shape != (C,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"batch_norm kernel takes {name} [{C}] f32 on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype}")


def _fwd_kernel(x, scale, bias, ra_mean, ra_var, residual, train, relu):
    _check(x, scale, bias, ra_mean, ra_var)
    if residual is not None:
        _check_act("residual", residual, x)
    C = x.shape[-1]
    rows = x.numel() // C
    P = row_blocks(rows, C, _sm_count(x.device.index or 0))
    y = torch.empty_like(x)
    if train:
        mean = torch.empty(C, dtype=torch.float32, device=x.device)
        var = torch.empty_like(mean)
        partial = torch.empty((2, P, C), dtype=torch.float32,
                              device=x.device)
    else:
        mean, var, partial = ra_mean, ra_var, None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[0](
            _DTYPES[x.dtype], int(train), int(relu), x.data_ptr(),
            0 if residual is None else residual.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), ra_mean.data_ptr(),
            ra_var.data_ptr(), mean.data_ptr(), var.data_ptr(), y.data_ptr(),
            0 if partial is None else partial.data_ptr(), rows, C, P, stream)
    if rc != 0:
        raise RuntimeError(f"batch_norm forward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    batch_norm.fwd_launches += 1
    return y, mean, var


def _bwd_kernel(x, out, dy, mean, var, scale, train, relu, residual):
    _check_act("x", x, x)
    _check_act("dy", dy, x)
    if relu:
        _check_act("out", out, x)
    C = x.shape[-1]
    rows = x.numel() // C
    P = row_blocks(rows, C, _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else None
    dscale = torch.empty(C, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    partial = torch.empty((2, P, C), dtype=torch.float32, device=x.device)
    ab = torch.empty((2, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[1](
            _DTYPES[x.dtype], int(train), int(relu), x.data_ptr(),
            out.data_ptr() if relu else 0, dy.data_ptr(), mean.data_ptr(),
            var.data_ptr(), scale.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), dx.data_ptr(),
            0 if dres is None else dres.data_ptr(), partial.data_ptr(),
            ab.data_ptr(), rows, C, P, stream)
    if rc != 0:
        raise RuntimeError(f"batch_norm backward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    batch_norm.bwd_launches += 1
    return dx, dscale, dbias, dres


class _BatchNorm(torch.autograd.Function):
    """out of (x, scale, bias, residual); saves x, out (with ReLU), the
    statistics used and scale. The running buffers are state, not
    inputs of the gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, ra_mean, ra_var, train, relu):
        if _on_card(x):
            out, mean, var = _fwd_kernel(x, scale, bias, ra_mean, ra_var,
                                         residual, train, relu)
            if not train:                  # buffers a later call may update
                mean, var = mean.clone(), var.clone()
        else:
            out, mean, var = batch_norm_reference(
                x, scale, bias, ra_mean, ra_var, train=train,
                residual=residual, relu=relu)
        ctx.save_for_backward(x, out if relu else None, mean, var, scale)
        ctx.flags = (train, relu, residual is not None)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out, mean, var, scale = ctx.saved_tensors
        train, relu, has_res = ctx.flags
        if _on_card(x):
            dx, dscale, dbias, dres = _bwd_kernel(x, out, dy, mean, var,
                                                  scale, train, relu,
                                                  has_res)
        else:
            dx, dscale, dbias, dres = batch_norm_backward_reference(
                x, out, dy, mean, var, scale, train=train, relu=relu,
                residual=has_res)
        return dx, dscale, dbias, dres, None, None, None, None


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               ra_mean: torch.Tensor, ra_var: torch.Tensor, *, train: bool,
               residual: Optional[torch.Tensor] = None, relu: bool = False
               ) -> torch.Tensor:
    """flax BatchNorm of the channels-last x [..., C] (+ residual, ReLU);
    training updates ``ra_mean``/``ra_var`` in place. One kernel call on
    the card."""
    return _BatchNorm.apply(x, scale, bias, residual, ra_mean, ra_var,
                            train, relu)


batch_norm.fwd_launches = 0
batch_norm.bwd_launches = 0

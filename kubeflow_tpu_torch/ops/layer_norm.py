"""LayerNorm with flax's semantics: the CUDA kernel (K20) and its plain
PyTorch version.

flax ``nn.LayerNorm``, which the JAX ViT uses, has epsilon 1e-6 (torch's
``layer_norm`` defaults to 1e-5), takes the variance as E[x^2] - E[x]^2
clipped at 0 (``use_fast_variance``) and forms y in f32 as (x - mean)
(rsqrt(var + eps) scale) + bias, rounded once to x's dtype.

:func:`layer_norm` is a ``torch.autograd.Function`` over the last dim whose
forward saves x, the row statistics ``mean`` and ``rstd`` [rows] f32 and
scale, and whose backward is written out from the formulas
(:func:`layer_norm_backward_reference`). It dispatches on where x lives:

- CUDA tensors launch ``ops/csrc/layer_norm.cu``, built at first use by
  ``ops/_build.py``, or raise: x bf16 or f32, contiguous and 16-byte
  aligned, the width a multiple of 8 up to :data:`MAX_WIDTH`; scale and
  bias f32. One launch a forward (a warp a row), two a backward (dx with
  per-block dscale/dbias partials, then their fixed-order sum): no
  atomics, two calls are bitwise equal.
- CPU tensors take the plain pair (:func:`layer_norm_reference`,
  :func:`layer_norm_backward_reference`), which is also what the card
  holds the kernel against.

Each forward launch adds one to ``layer_norm.fwd_launches``, each backward
call to ``layer_norm.bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_SOURCE = "layer_norm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: flax nn.LayerNorm's epsilon; the kernel has it as a constant
#: (layer_norm.cu's kEps).
EPS = 1e-6
#: The widest row the kernel takes (8 elements x 32 lanes x 4 chunks):
#: ViT-L/16's 1024.
MAX_WIDTH = 1024


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) in plain PyTorch, the kernel's arithmetic in its
    order: mean and var = max(0, E[x^2] - mean^2) over the last dim in f32,
    rstd = 1 / sqrt(var + EPS), y = (x - mean) (rstd scale) + bias in f32
    rounded once to x's dtype; mean and rstd [...] f32."""
    E = x.shape[-1]
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / E
    var = ((xf * xf).sum(-1, keepdim=True) / E - mean * mean).clamp_min(0.0)
    rstd = 1.0 / torch.sqrt(var + EPS)
    y = ((xf - mean) * (rstd * scale.float()) + bias.float()).to(x.dtype)
    return y, mean[..., 0], rstd[..., 0]


def layer_norm_backward_reference(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of :func:`layer_norm_reference`, from the
    formulas: with xh = (x - mean) rstd and g = dy scale (f32), dx = rstd
    ((g - mean(g)) - xh mean(g xh)) in x's dtype; dscale = sum over rows of
    dy xh, dbias = sum of dy, f32 [E]."""
    E = x.shape[-1]
    m, r = mean[..., None], rstd[..., None]
    xh = (x.float() - m) * r
    d = dy.float()
    g = d * scale.float()
    a = g.sum(-1, keepdim=True) / E
    b = (g * xh).sum(-1, keepdim=True) / E
    dx = (r * ((g - a) - xh * b)).to(x.dtype)
    dscale = (d * xh).reshape(-1, E).sum(0)
    dbias = d.reshape(-1, E).sum(0)
    return dx, dscale, dbias


def bind(lib: ctypes.CDLL):
    """K20's C entry points (forward, backward) with their signatures."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = lib.kftpu_layer_norm_fwd
    fwd.restype = i
    fwd.argtypes = [i] + [p] * 6 + [ctypes.c_longlong, i, p]
    bwd = lib.kftpu_layer_norm_bwd
    bwd.restype = i
    bwd.argtypes = [i] + [p] * 9 + [ctypes.c_longlong, i, i, p]
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"layer_norm runs on cuda (kernel) or cpu (plain "
                     f"version), not {x.device}")


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    E = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"layer_norm kernel takes bf16 or f32 x, got "
                         f"{x.dtype}")
    if E % 8 or E > MAX_WIDTH or x.numel() == 0:
        raise ValueError(f"layer_norm kernel takes a width that is a "
                         f"multiple of 8 up to {MAX_WIDTH} and a non-empty "
                         f"x, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm kernel takes a contiguous, 16-byte "
                         "aligned x (it copies nothing)")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (E,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"layer_norm kernel takes {name} [{E}] f32, "
                             f"contiguous and 16-byte aligned, on "
                             f"{x.device}; got {tuple(t.shape)} {t.dtype}")


def _fwd_kernel(x, scale, bias):
    _check(x, scale, bias)
    E = x.shape[-1]
    rows = x.numel() // E
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[0](_DTYPES[x.dtype], x.data_ptr(),
                              scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                              mean.data_ptr(), rstd.data_ptr(), rows, E,
                              stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm forward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    layer_norm.fwd_launches += 1
    return y, mean, rstd


def _bwd_kernel(x, scale, dy, mean, rstd):
    _check(x, scale, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    E = x.shape[-1]
    rows = x.numel() // E
    blocks = min(-(-rows // 8), 2 * _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dscale = torch.empty(E, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    partial = torch.empty((2, blocks, E), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[1](_DTYPES[x.dtype], x.data_ptr(),
                              scale.data_ptr(), dy.data_ptr(),
                              mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                              dscale.data_ptr(), dbias.data_ptr(),
                              partial.data_ptr(), rows, E, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm backward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    layer_norm.bwd_launches += 1
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """y of (x, scale, bias); saves x, scale, mean and rstd."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        if _on_card(x):
            y, mean, rstd = _fwd_kernel(x, scale, bias)
        else:
            y, mean, rstd = layer_norm_reference(x, scale, bias)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        if _on_card(x):
            dx, dscale, dbias = _bwd_kernel(x, scale, dy, mean, rstd)
        else:
            dx, dscale, dbias = layer_norm_backward_reference(
                x, scale, dy, mean, rstd)
        return dx, dscale, dbias


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """flax LayerNorm over the last dim (statistics in f32, output in x's
    dtype); one kernel launch on the card."""
    return _LayerNorm.apply(x, scale, bias)


layer_norm.fwd_launches = 0
layer_norm.bwd_launches = 0

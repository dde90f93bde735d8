"""Bias add + GELU (flax ``nn.gelu``'s default tanh form): the CUDA kernel
(K21) and its plain PyTorch version.

The ViT MLP's ``mlp_in`` is a bf16 Dense followed by ``nn.gelu``. JAX adds
the Dense's bias after the product is rounded (a GEMM's fused bias
epilogue does not), and ``nn.gelu`` is the tanh approximation with its
constants in the activation dtype and every operation rounded to it
(``jax.nn.gelu(approximate=True)``; torch's ``F.gelu`` defaults to the
exact erf form). So the product runs without its bias (``F.linear``) and
:func:`bias_gelu` takes the rest.

:func:`bias_gelu` is a ``torch.autograd.Function`` that saves x and the
bias and whose backward is written out from the formula
(:func:`bias_gelu_backward_reference`): the gradient of x (the product)
and of the bias, summed over the rows. It dispatches on where x lives:

- CUDA tensors launch ``ops/csrc/gelu.cu``, built at first use by
  ``ops/_build.py``, or raise: x bf16 or f32, contiguous and 16-byte
  aligned, the width a multiple of 8; the bias [F] in x's dtype. One
  launch a forward (a block a run of rows), a call of two a backward
  (dx with per-block partial sums of the bias gradient, then their
  fixed-order sum): no atomics.
- CPU tensors take the plain pair (:func:`bias_gelu_reference`,
  :func:`bias_gelu_backward_reference`), which is also what the card
  holds the kernel against.

Each forward launch adds one to ``bias_gelu.fwd_launches``, each backward
call to ``bias_gelu.bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from kubeflow_tpu_torch.ops.batch_norm import row_blocks

_SOURCE = "gelu.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def constants(dtype: torch.dtype) -> Tuple[float, float]:
    """jax.nn.gelu's tanh-form constants as it holds them for ``dtype``:
    sqrt(2 / pi) cast to the dtype and 0.044715 (a weak Python float),
    rounded to the dtype at the multiply."""
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float64)
    c2 = torch.tensor(0.044715, dtype=torch.float64)
    return float(c1.to(dtype)), float(c2.to(dtype))


def bias_gelu_reference(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """gelu(x + bias) in plain PyTorch, the kernel's arithmetic in its
    order: every operation in f32, rounded to x's dtype, as jax.nn.gelu
    rounds its bf16 operations."""
    dtype = x.dtype
    c1, c2 = constants(dtype)

    def r(t):
        return t.to(dtype).float()

    h = r(x.float() + bias.to(dtype).float())
    u = r(r(r(h * h) * h) * c2)
    v = r(r(h + u) * c1)
    t = r(torch.tanh(v))
    return (h * r(r(t + 1.0) * 0.5)).to(dtype)


def bias_gelu_backward_reference(x: torch.Tensor, bias: torch.Tensor,
                                 dy: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dbias) of :func:`bias_gelu_reference` from the formula: with h
    = x + bias rounded and t = tanh(c1 (h + c2 h^3)), dx = dy (0.5 (1 + t)
    + 0.5 h (1 - t^2) c1 (1 + 3 c2 h^2)) in f32 rounded once to x's dtype;
    dbias = sum over rows of dx in f32, rounded once."""
    dtype = x.dtype
    c1, c2 = constants(dtype)
    F = x.shape[-1]
    h = (x.float() + bias.to(dtype).float()).to(dtype).float()
    h2 = h * h
    t = torch.tanh((h + (h2 * h) * c2) * c1)
    left = (t + 1.0) * 0.5
    sech2 = 1.0 - t * t
    inner = ((h2 * (3.0 * c2)) + 1.0) * c1
    grad = left + ((h * 0.5) * sech2) * inner
    dx = (dy.float() * grad).to(dtype)
    dbias = dx.float().reshape(-1, F).sum(0).to(dtype)
    return dx, dbias


def bind(lib: ctypes.CDLL):
    """K21's C entry points (forward, backward) with their signatures."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = lib.kftpu_bias_gelu_fwd
    fwd.restype = i
    fwd.argtypes = [i] + [p] * 3 + [ctypes.c_longlong, i, i, f, f, p]
    bwd = lib.kftpu_bias_gelu_bwd
    bwd.restype = i
    bwd.argtypes = [i] + [p] * 6 + [ctypes.c_longlong, i, i, f, f, p]
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
    raise ValueError(f"bias_gelu runs on cuda (kernel) or cpu (plain "
                     f"version), not {x.device}")


def _check(x: torch.Tensor, bias: torch.Tensor) -> None:
    F = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"bias_gelu kernel takes bf16 or f32 x, got "
                         f"{x.dtype}")
    if F % 8 or x.numel() == 0:
        raise ValueError(f"bias_gelu kernel takes a width that is a multiple "
                         f"of 8 and a non-empty x, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("bias_gelu kernel takes a contiguous, 16-byte "
                         "aligned x (it copies nothing)")
    if bias.shape != (F,) or bias.dtype != x.dtype \
            or bias.device != x.device or not bias.is_contiguous() \
            or bias.data_ptr() % 16:
        raise ValueError(f"bias_gelu kernel takes a bias [{F}] {x.dtype}, "
                         f"contiguous and 16-byte aligned, on {x.device}; "
                         f"got {tuple(bias.shape)} {bias.dtype}")


def _fwd_kernel(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check(x, bias)
    F = x.shape[-1]
    rows = x.numel() // F
    blocks = row_blocks(rows, F, _sm_count(x.device.index or 0))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[0](_DTYPES[x.dtype], x.data_ptr(), bias.data_ptr(),
                              y.data_ptr(), rows, F, blocks,
                              *constants(x.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"bias_gelu forward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    bias_gelu.fwd_launches += 1
    return y


def _bwd_kernel(x, bias, dy) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, bias)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    F = x.shape[-1]
    rows = x.numel() // F
    P = row_blocks(rows, F, _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dbias = torch.empty_like(bias)
    partial = torch.empty((P, F), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[1](_DTYPES[x.dtype], x.data_ptr(), bias.data_ptr(),
                              dy.data_ptr(), dx.data_ptr(), dbias.data_ptr(),
                              partial.data_ptr(), rows, F, P,
                              *constants(x.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"bias_gelu backward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    bias_gelu.bwd_launches += 1
    return dx, dbias


class _BiasGelu(torch.autograd.Function):
    """gelu(x + bias); saves x and bias."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        if _on_card(x):
            return _fwd_kernel(x, bias)
        return bias_gelu_reference(x, bias)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        if _on_card(x):
            return _bwd_kernel(x, bias, dy)
        return bias_gelu_backward_reference(x, bias, dy)


def bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """gelu(x + bias) for x [..., F] and bias [F] in x's dtype (the tanh
    form, JAX's rounding); one kernel launch on the card."""
    return _BiasGelu.apply(x, bias)


bias_gelu.fwd_launches = 0
bias_gelu.bwd_launches = 0

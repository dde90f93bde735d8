"""SwiGLU, ``silu(gate) * up``: the CUDA kernel (K9) and its plain PyTorch
version.

:func:`swiglu` takes gate and up as two tensors [..., F];
:func:`swiglu_fused` takes them as the two halves of one fused product
``gu`` [..., 2, F] (``LlamaConfig.fused_gate_up``), read in place. Both go
through one ``torch.autograd.Function`` that saves gate and up (in the
fused form, ``gu``) and nothing else, and whose backward is written out
from the formulas (:func:`swiglu_backward_reference`), not replayed op by
op; the fused form's gradient is one [..., 2, F] tensor, written whole
(no ``cat``, no zero-fill). It dispatches on where the tensors live:

- CUDA tensors launch ``ops/csrc/swiglu.cu``, built at first use by
  ``ops/_build.py``, or raise: bf16 or f32 of one dtype, F a multiple of
  8, each row contiguous and 16-byte aligned. One launch a forward, one a
  backward, on the current stream, capture-safe.
- CPU tensors take the plain pair (:func:`swiglu_reference`,
  :func:`swiglu_backward_reference`), which is also what the card holds
  the kernel against; both compute in f32 with one rounding an operation
  and round to the dtype at the same points, so they agree bitwise.

Each forward launch adds one to ``swiglu.fwd_launches``, each backward
launch to ``swiglu.bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_SOURCE = "swiglu.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _silu_parts(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(den, silu) in f32 for f32 g: den = 1 + exp(-g), silu = g / den (the
    formula of PyTorch's own silu kernel)."""
    den = torch.exp(-g) + 1.0
    return den, g / den


def swiglu_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in plain PyTorch, f32 arithmetic rounded to the
    dtype twice, where an eager ``F.silu(gate) * up`` rounds: after the
    silu and after the product."""
    dtype = gate.dtype
    _, silu = _silu_parts(gate.float())
    a = silu.to(dtype).float()
    return (a * up.float()).to(dtype)


def swiglu_backward_reference(
    gate: torch.Tensor, up: torch.Tensor, dh: torch.Tensor,
    dgate: Optional[torch.Tensor] = None, dup: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgate, dup) of :func:`swiglu_reference`, from the formulas: with s =
    1 / (1 + exp(-gate)) and a the forward's rounded silu, dup = dh a and,
    from t = dh up rounded as eager autograd rounds the silu's incoming
    gradient, dgate = (t s)(1 + gate (1 - s)). Written into ``dgate`` and
    ``dup`` when given (views of one fused gradient), else new tensors."""
    dtype = gate.dtype
    g, d = gate.float(), dh.float()
    den, silu = _silu_parts(g)
    s = 1.0 / den
    a = silu.to(dtype).float()
    du = (d * a).to(dtype)
    t = (d * up.float()).to(dtype).float()
    dg = ((t * s) * ((g * (1.0 - s)) + 1.0)).to(dtype)
    if dgate is None:
        return dg, du
    dgate.copy_(dg)
    dup.copy_(du)
    return dgate, dup


def bind(lib: ctypes.CDLL):
    """K9's C entry points (forward, backward) with their signatures."""
    fwd = lib.kftpu_swiglu_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_int]
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    bwd = lib.kftpu_swiglu_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                    + [ctypes.c_longlong, ctypes.c_int]
                    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"swiglu runs on cuda (kernel) or cpu (plain "
                     f"version), not {x.device}")


def _row_stride(name: str, t: torch.Tensor, F: int) -> int:
    """The stride between t's rows of width F, as the kernel reads them:
    each row contiguous, every row start 16-byte aligned, and the rows
    evenly spaced (a contiguous tensor, or a half of a fused product)."""
    per = 16 // t.element_size()
    if t.dim() == 1:
        stride = F
    else:
        stride = t.stride(-2)
        lead = t.shape[:-1]
        expect = stride
        for dim in range(t.dim() - 2, -1, -1):
            if lead[dim] != 1 and t.stride(dim) != expect:
                raise ValueError(f"swiglu kernel takes evenly spaced rows of "
                                 f"{name}, got strides {t.stride()}")
            expect *= lead[dim]
    if t.stride(-1) != 1 or t.data_ptr() % 16 or stride % per:
        raise ValueError(f"swiglu kernel takes contiguous, 16-byte aligned "
                         f"rows of {name}, got strides {t.stride()}")
    return stride


def _check(gate: torch.Tensor, up: torch.Tensor) -> None:
    if gate.dtype not in _DTYPES or up.dtype != gate.dtype \
            or up.shape != gate.shape or up.device != gate.device:
        raise ValueError(f"swiglu kernel takes bf16 or f32 gate and up of one "
                         f"shape, dtype and device; got {tuple(gate.shape)} "
                         f"{gate.dtype} and {tuple(up.shape)} {up.dtype}")
    F = gate.shape[-1]
    if F % 8 or gate.numel() == 0:
        raise ValueError(f"swiglu kernel takes a width that is a multiple of "
                         f"8 and non-empty rows, got {tuple(gate.shape)}")


def _launch_check(rc: int, what: str, gate: torch.Tensor) -> None:
    if rc != 0:
        raise RuntimeError(f"swiglu {what} launch failed: CUDA error {rc} "
                           f"(gate {tuple(gate.shape)} {gate.dtype})")


def _fwd_kernel(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    _check(gate, up)
    F = gate.shape[-1]
    gs, us = _row_stride("gate", gate, F), _row_stride("up", up, F)
    h = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    with torch.cuda.device(gate.device):
        stream = torch.cuda.current_stream(gate.device).cuda_stream
        rc = _kernel_fns()[0](_DTYPES[gate.dtype], gate.data_ptr(),
                              up.data_ptr(), h.data_ptr(),
                              gate.numel() // F, F, gs, us, stream)
    _launch_check(rc, "forward", gate)
    swiglu.fwd_launches += 1
    return h


def _bwd_kernel(gate, up, dh, dgate, dup) -> None:
    """dgate and dup (views the caller made) written from gate, up, dh."""
    _check(gate, up)
    F = gate.shape[-1]
    if dh.shape != gate.shape or dh.dtype != gate.dtype:
        raise ValueError(f"dh {tuple(dh.shape)} {dh.dtype} does not match "
                         f"gate {tuple(gate.shape)} {gate.dtype}")
    dh = dh.contiguous()
    strides = [_row_stride(n, t, F) for n, t in
               (("gate", gate), ("up", up), ("dgate", dgate), ("dup", dup))]
    with torch.cuda.device(gate.device):
        stream = torch.cuda.current_stream(gate.device).cuda_stream
        rc = _kernel_fns()[1](_DTYPES[gate.dtype], gate.data_ptr(),
                              up.data_ptr(), dh.data_ptr(), dgate.data_ptr(),
                              dup.data_ptr(), gate.numel() // F, F, *strides,
                              stream)
    _launch_check(rc, "backward", gate)
    swiglu.bwd_launches += 1


def _forward(gate, up):
    if _on_card(gate):
        return _fwd_kernel(gate, up)
    return swiglu_reference(gate, up)


def _backward(gate, up, dh, dgate, dup):
    if _on_card(gate):
        _bwd_kernel(gate, up, dh, dgate, dup)
    else:
        swiglu_backward_reference(gate, up, dh, dgate, dup)


class _SwiGLU(torch.autograd.Function):
    """h of (gate, up); saves gate and up."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _forward(gate, up)

    @staticmethod
    def backward(ctx, dh):
        gate, up = ctx.saved_tensors
        dgate, dup = torch.empty_like(gate), torch.empty_like(up)
        _backward(gate, up, dh, dgate, dup)
        return dgate, dup


class _SwiGLUFused(torch.autograd.Function):
    """h of gu [..., 2, F]; saves gu. Its gradient is one [..., 2, F]
    tensor whose halves the backward writes."""

    @staticmethod
    def forward(ctx, gu):
        ctx.save_for_backward(gu)
        return _forward(gu[..., 0, :], gu[..., 1, :])

    @staticmethod
    def backward(ctx, dh):
        (gu,) = ctx.saved_tensors
        dgu = torch.empty(gu.shape, dtype=gu.dtype, device=gu.device)
        _backward(gu[..., 0, :], gu[..., 1, :], dh, dgu[..., 0, :],
                  dgu[..., 1, :])
        return dgu


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up for gate, up [..., F]; one kernel launch on the
    card."""
    return _SwiGLU.apply(gate, up)


def swiglu_fused(gu: torch.Tensor) -> torch.Tensor:
    """silu(gu[..., 0, :]) * gu[..., 1, :] for the fused product gu
    [..., 2, F], its halves read in place; [..., F]."""
    if gu.dim() < 2 or gu.shape[-2] != 2:
        raise ValueError(f"swiglu_fused takes [..., 2, F], got "
                         f"{tuple(gu.shape)}")
    return _SwiGLUFused.apply(gu)


swiglu.fwd_launches = 0
swiglu.bwd_launches = 0

"""The int8 expert product (K15) and its plain version.

:func:`int8_experts` computes ``y[e] = x[e] @ W[e].T`` for every expert e
of a Mixtral expert bank held as int8 ``q`` [E, N, K] and ``scale`` [1, N,
K]: ``W[e, n, k] = q[e, n, k] * scale[0, n, k]`` rounded once to the
product's dtype, x [E, R, K] (R rows an expert: the dispatch's groups times
its capacity), y [E, R, N]. One scale an element, shared by the experts:
the JAX engine quantizes an expert leaf [E, K, N] over its expert axis
(``_quantize_leaf(x, 0)``), so its scales are [1, K, N]; the port stores q
and scale transposed, K contiguous, as K4 reads its weights.

That is what the JAX engine's jitted steps compute: ``_materialize`` forms
``q * scale`` in bf16 (one rounding of an exact product) and the expert
einsums of ``kubeflow_tpu/models/mixtral.py`` sum in f32
(``preferred_element_type``) and round once. With f32 activations XLA
keeps the dequantized weight in f32, so the f32 CPU tests match the JAX
engine with the unrounded weight (as ``ops/int8_linear.py`` notes).

It dispatches on where x lives:

- CUDA tensors launch ``ops/csrc/int8_experts.cu``, built at first use by
  ``ops/_build.py``, or raise: the kernel takes bf16 x and output, N and K
  multiples of 16, any E and R >= 1, contiguous operands. Up to 16 rows an
  expert, a TMA-fed block a group of 8 experts (each scale reaches the SM
  once); more rows, a TMA + wgmma kernel whose grid runs the experts of a
  row tile together while x is small. The weight is never dequantized
  whole; the kernel is capture-safe and deterministic, and a launch it
  refuses (a shape, a tensor map) raises here.
- CPU tensors take :func:`int8_experts_reference`, which dequantizes the
  leaf as ``_materialize`` does and calls ``torch.bmm``. It is also what
  ``chip_smoke.py`` holds the kernel against on the card.

Each kernel launch adds one to ``int8_experts.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_SOURCE = "int8_experts.cu"


def dequantize_experts(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain weights [E, N, K] in ``dtype``: ``q * scale``, formed
    exactly in f32 and rounded once (in bf16 bitwise the JAX engine's
    ``_materialize`` of the leaf, transposed)."""
    return (q.float() * scale.float()).to(dtype)


def int8_experts_reference(x: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor, *,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """[E, R, N] in ``out_dtype`` (x's by default): the leaf dequantized to
    ``out_dtype`` and applied with ``torch.bmm``."""
    dt = out_dtype or x.dtype
    return torch.bmm(x.to(dt), dequantize_experts(q, scale, dt).transpose(1, 2))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """K15's C entry point, built and loaded at first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    fn = load_library(_SOURCE).kftpu_int8_experts
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _check(x, q, scale, out_dtype):
    """(E, R, N, K) of operands the kernel takes, or ValueError."""
    if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != torch.bfloat16:
        raise ValueError(f"int8_experts kernel takes bf16 x and output, got "
                         f"x {x.dtype}, out {out_dtype}")
    if q.dtype != torch.int8 or q.dim() != 3:
        raise ValueError(f"int8_experts kernel takes an int8 [E, N, K] "
                         f"weight, got {q.dtype} {tuple(q.shape)}")
    E, N, K = q.shape
    if N % 16 or K % 16:
        raise ValueError(f"int8_experts kernel takes N and K multiples of "
                         f"16, got [{E}, {N}, {K}]")
    if scale.dtype != torch.bfloat16 or tuple(scale.shape) != (1, N, K):
        raise ValueError(f"int8_experts kernel takes a bf16 scale [1, {N}, "
                         f"{K}], got {scale.dtype} {tuple(scale.shape)}")
    if x.dim() != 3 or x.shape[0] != E or x.shape[2] != K or x.shape[1] < 1:
        raise ValueError(f"x {tuple(x.shape)} is not [{E}, R >= 1, {K}]")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_experts kernel takes contiguous, 16-byte "
                             f"aligned operands ({name})")
    return E, x.shape[1], N, K


def _kernel(x, q, scale, out_dtype):
    E, R, N, K = _check(x, q, scale, out_dtype)
    y = torch.empty((E, R, N), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fn()(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                          y.data_ptr(), E, R, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"int8_experts launch failed: CUDA error {rc} "
                           f"(x [{E}, {R}, {K}], weights [{E}, {N}, {K}])")
    int8_experts.launches += 1
    return y


def int8_experts(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[E, R, N] in ``out_dtype``; arguments as
    :func:`int8_experts_reference`."""
    if x.device.type == "cuda":
        return _kernel(x, q, scale, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_experts runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    return int8_experts_reference(x, q, scale, out_dtype=out_dtype)


int8_experts.launches = 0

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

At a decode step's rows, :func:`int8_experts_swiglu` takes gate and up
together from the dispatch's token rows: ``h = silu(x_e Wg[e].T) * (x_e
Wu[e].T)`` with ``x_e`` expert e's rows gathered by ``slot_tok`` and
multiplied by ``slot_valid`` (``ops/moe.py``'s K13), [E, R, F]. On CUDA
tensors it is one launch of ``int8_experts.cu``'s fused decode kernel (at
most :data:`DECODE_MAX_ROWS` rows an expert of at most
:data:`SWIGLU_MAX_TOKENS` tokens), bitwise K13, K15's gate and up products
and K9 (``ops/swiglu.py``) one after the other; on CPU tensors
:func:`int8_experts_swiglu_reference`, that chain's plain versions.

Each kernel launch adds one to ``int8_experts.launches``; the fused one
also to ``int8_experts.swiglu_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kubeflow_tpu_torch.ops.moe import gather_rows_reference
from kubeflow_tpu_torch.ops.swiglu import swiglu_reference

_SOURCE = "int8_experts.cu"
#: The most rows an expert :func:`int8_experts_swiglu`'s kernel takes.
DECODE_MAX_ROWS = 16
#: The most tokens x it reads them from (one TMA box a stage).
SWIGLU_MAX_TOKENS = 256


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


def int8_experts_swiglu_reference(x: torch.Tensor, slot_tok: torch.Tensor,
                                  slot_valid: torch.Tensor,
                                  gate_q: torch.Tensor, gate_s: torch.Tensor,
                                  up_q: torch.Tensor, up_s: torch.Tensor,
                                  rows: int) -> torch.Tensor:
    """h [E, R = ``rows``, F] in x's dtype: the token rows x [T, K] gathered
    into the expert buffers (``gather_rows_reference``), gate's and up's
    products (:func:`int8_experts_reference`), then ``swiglu_reference``."""
    x_e = gather_rows_reference(x, slot_tok, slot_valid).view(
        gate_q.shape[0], rows, x.shape[1])
    return swiglu_reference(int8_experts_reference(x_e, gate_q, gate_s),
                            int8_experts_reference(x_e, up_q, up_s))


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """K15's C entry points (the product, the fused gate/up with SwiGLU),
    built and loaded at first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.kftpu_int8_experts
    fn.restype = i
    fn.argtypes = [p] * 4 + [i] * 4 + [p]
    fused = lib.kftpu_int8_experts_swiglu
    fused.restype = i
    fused.argtypes = [p] * 8 + [i] * 5 + [p]
    return fn, fused


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
        rc = _kernel_fns()[0](x.data_ptr(), q.data_ptr(), scale.data_ptr(),
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


def _swiglu_kernel(x, slot_tok, slot_valid, gate_q, gate_s, up_q, up_s,
                   rows):
    E, F, K = gate_q.shape if gate_q.dim() == 3 else (0, 0, 0)
    T = x.shape[0] if x.dim() == 2 else 0
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"int8_experts_swiglu kernel takes bf16 x [T, "
                         f"{K}], got {x.dtype} {tuple(x.shape)}")
    if not 1 <= rows <= DECODE_MAX_ROWS or not 1 <= T <= SWIGLU_MAX_TOKENS:
        raise ValueError(f"int8_experts_swiglu kernel takes 1 to "
                         f"{DECODE_MAX_ROWS} rows an expert of 1 to "
                         f"{SWIGLU_MAX_TOKENS} tokens, got {rows} of {T}")
    for name, q, s in (("gate", gate_q, gate_s), ("up", up_q, up_s)):
        if q.dtype != torch.int8 or tuple(q.shape) != (E, F, K) \
                or s.dtype != torch.bfloat16 or tuple(s.shape) != (1, F, K):
            raise ValueError(f"int8_experts_swiglu kernel takes int8 gate "
                             f"and up [E, F, K] of one shape with bf16 "
                             f"scales [1, F, K]: gate {tuple(gate_q.shape)}, "
                             f"{name} {q.dtype} {tuple(q.shape)}, scale "
                             f"{s.dtype} {tuple(s.shape)}")
    if F % 16 or K % 16:
        raise ValueError(f"int8_experts_swiglu kernel takes F and K "
                         f"multiples of 16, got F {F}, K {K}")
    if slot_tok.dtype != torch.int32 or slot_valid.dtype != torch.bfloat16 \
            or tuple(slot_tok.shape) != (E * rows,) \
            or tuple(slot_valid.shape) != (E * rows,):
        raise ValueError(f"int8_experts_swiglu kernel takes int32 slot_tok "
                         f"and bf16 slot_valid [{E * rows}], got "
                         f"{slot_tok.dtype} {tuple(slot_tok.shape)}, "
                         f"{slot_valid.dtype} {tuple(slot_valid.shape)}")
    ts = (("x", x), ("slot_tok", slot_tok), ("slot_valid", slot_valid),
          ("gate_q", gate_q), ("gate_s", gate_s), ("up_q", up_q),
          ("up_s", up_s))
    for name, t in ts:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_experts_swiglu kernel takes contiguous, "
                             f"16-byte aligned operands ({name})")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("int8_experts_swiglu has no backward")
    h = torch.empty((E, rows, F), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[1](*(t.data_ptr() for _, t in ts), h.data_ptr(),
                              T, E, rows, F, K, stream)
    if rc != 0:
        raise RuntimeError(f"int8_experts_swiglu launch failed: CUDA error "
                           f"{rc} (x [{T}, {K}], {rows} rows an expert, "
                           f"weights [{E}, {F}, {K}])")
    int8_experts.launches += 1
    int8_experts.swiglu_launches += 1
    return h


def int8_experts_swiglu(x: torch.Tensor, slot_tok: torch.Tensor,
                        slot_valid: torch.Tensor, gate_q: torch.Tensor,
                        gate_s: torch.Tensor, up_q: torch.Tensor,
                        up_s: torch.Tensor, rows: int) -> torch.Tensor:
    """h [E, ``rows``, F]; arguments as
    :func:`int8_experts_swiglu_reference`. CUDA tensors: one fused launch
    (bf16 x and slot_valid, int32 slot_tok, at most
    :data:`DECODE_MAX_ROWS` rows an expert of at most
    :data:`SWIGLU_MAX_TOKENS` tokens) or ValueError/RuntimeError; CPU
    tensors: the plain chain."""
    if x.device.type == "cuda":
        return _swiglu_kernel(x, slot_tok, slot_valid, gate_q, gate_s, up_q,
                              up_s, rows)
    if x.device.type != "cpu":
        raise ValueError(f"int8_experts_swiglu runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    return int8_experts_swiglu_reference(x, slot_tok, slot_valid, gate_q,
                                         gate_s, up_q, up_s, rows)


int8_experts.launches = 0
int8_experts.swiglu_launches = 0

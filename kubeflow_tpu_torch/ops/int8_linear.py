"""Products with int8 weights: the CUDA kernel (K4) and its plain version.

:func:`int8_linear` computes ``x @ W.T`` with the weight held as int8
``q`` [N, K] and ``scale`` [N, S]: ``W[n, k] = q[n, k] * scale[n, k mod S]``
rounded once to the product's dtype. ``S`` is 1 (one scale an output row)
or, for ``o_proj``, ``head_dim`` (one scale an (output row, head dim)
pair: the JAX kernel [H, Dh, E] is scaled over its heads only).

That is what the JAX engine's jitted steps compute: ``_materialize`` forms
``q * scale`` in ``param_dtype or bfloat16`` (one rounding of an exact
product) and DenseGeneral casts it to the activation dtype. With bf16
activations, as served, each weight is rounded to bf16. With f32
activations XLA keeps the product in f32 (it drops the bf16 round trip:
excess precision is allowed by default), so the f32 CPU tests match the
JAX engine only with the unrounded weight.

:func:`int8_linear_group` computes up to three such products of the same
x (q/k/v, gate/up) in one kernel launch, each into its own output.

:func:`int8_linear_swiglu` computes ``silu(x @ Wg.T) * (x @ Wu.T)`` of a
gate and an up weight with per-row scales: on the card at a decode step's
rows (M <= :data:`DECODE_MAX_ROWS`) one K4 launch whose epilogue is K9's
function, bitwise K4's grouped launch followed by K9 (``ops/swiglu.py``).
Its plain version composes :func:`int8_linear_reference` with
:func:`~kubeflow_tpu_torch.ops.swiglu.swiglu_reference`.

Both dispatch on where x lives:

- CUDA tensors launch ``ops/csrc/int8_linear.cu``, built at first use by
  ``ops/_build.py``, or raise: the kernel takes bf16 x and output,
  N and K multiples of 16, any M >= 1, and S of 1 or a multiple of
  16 up to 256 dividing K (in a group, all S = 1 or all S > 1). It reads
  the int8 bytes directly (the weight is never dequantized whole), is
  capture-safe and deterministic.
- CPU tensors take :func:`int8_linear_reference`, which dequantizes as
  ``_materialize`` does and calls ``F.linear`` (a group: once a product).
  It is also what ``chip_smoke.py`` holds the kernel against on the card.

Each kernel launch, single, grouped or with the SwiGLU epilogue, adds one
to ``int8_linear.launches``; each SwiGLU-epilogue launch also adds one to
``int8_linear.swiglu_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops.swiglu import swiglu_reference

_SOURCE = "int8_linear.cu"
#: The largest per-column scale period the kernel stages.
MAX_PERIOD = 256
#: The most products one grouped launch takes.
MAX_GROUP = 3
#: The most rows (tokens) of K4's decode kernel (``mma.sync``), the only
#: one with the SwiGLU epilogue; more rows take the prefill kernel.
DECODE_MAX_ROWS = 16


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain weight [N, K] in ``dtype``: ``q * scale``, scale [N, S]
    repeating along K with period S, formed exactly in f32 and rounded
    once (in bf16 bitwise the JAX engine's ``_materialize``)."""
    n, k = q.shape
    s = scale.shape[1]
    return (q.float().view(n, k // s, s)
            * scale.float().view(n, 1, s)).view(n, k).to(dtype)


def int8_linear_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor, *,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """[..., N] in ``out_dtype`` (x's by default): the weight dequantized
    to ``out_dtype`` and applied with ``F.linear``, as flax's DenseGeneral
    applies the materialized kernel."""
    dt = out_dtype or x.dtype
    return F.linear(x.to(dt), dequantize_int8(q, scale, dt))


def bind(lib: ctypes.CDLL):
    """K4's C entry points in ``lib`` with their ctypes signatures: the
    blocks of a cluster that split K for (M, N, K, S), and the launch of
    one to three products of the same x. (``kftpu_int8_linear``, one
    product, keeps the first build's signature for ``kernel_ab.py``.)"""
    splits = lib.kftpu_int8_linear_splits
    splits.restype = ctypes.c_int
    splits.argtypes = [ctypes.c_int] * 4
    group = lib.kftpu_int8_linear_group
    group.restype = ctypes.c_int
    group.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 5
                      + [ctypes.c_int, ctypes.c_void_p])
    return splits, group


def bind_swiglu(lib: ctypes.CDLL):
    """K4's SwiGLU-epilogue C entry point with its ctypes signature."""
    fn = lib.kftpu_int8_linear_swiglu
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """K4's C entry points, built and loaded at first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


@functools.lru_cache(maxsize=None)
def _swiglu_fn():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind_swiglu(load_library(_SOURCE))


def _check_weight(q, scale, x):
    """(N, K, S) of a weight the kernel takes, or ValueError."""
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError("int8_linear kernel takes a contiguous int8 [N, K] "
                         "weight")
    N, K = q.shape
    if N % 16 or K % 16:
        raise ValueError(f"int8_linear kernel takes N and K multiples of 16, "
                         f"got [{N}, {K}]")
    if scale.dtype != torch.bfloat16 or scale.dim() != 2 \
            or scale.shape[0] != N or not scale.is_contiguous():
        raise ValueError(f"int8_linear kernel takes a contiguous bf16 scale "
                         f"[{N}, S], got {scale.dtype} {tuple(scale.shape)}")
    S = scale.shape[1]
    if S != 1 and (S % 16 or S > MAX_PERIOD or K % S):
        raise ValueError(f"int8_linear kernel takes a scale period of 1 or a "
                         f"multiple of 16 up to {MAX_PERIOD} dividing K "
                         f"{K}, got {S}")
    if x.shape[-1] != K:
        raise ValueError(f"x's last dim {x.shape[-1]} != K {K}")
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("int8_linear kernel needs 16-byte aligned operands")
    return N, K, S


def _rows(x, out_dtype, K):
    """x as [M, K] rows with unit column stride, checked for the kernel."""
    if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != torch.bfloat16:
        raise ValueError(f"int8_linear kernel takes bf16 x and output, got "
                         f"x {x.dtype}, out {out_dtype}")
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    if x2.shape[0] < 1:
        raise ValueError("int8_linear kernel takes M >= 1 rows")
    if x2.stride(0) % 8 or x2.data_ptr() % 16:
        raise ValueError("int8_linear kernel needs 16-byte aligned operands "
                         "and an x row stride a multiple of 8")
    return x2


def _kernel(x, q, scale, out_dtype, splits: int = 0):
    """K4 on CUDA tensors; ``splits`` (1, 2, 4 or 8; M <= 16) overrides
    the blocks of a cluster that split K (0: the kernel's choice)."""
    return _group_kernel(x, [(q, scale)], out_dtype, splits)[0]


def _group_kernel(x, pairs, out_dtype, splits: int = 0):
    """K4 on CUDA tensors: one launch for the products of ``pairs``
    (``splits`` as :func:`_kernel`'s)."""
    shapes = [_check_weight(q, scale, x) for q, scale in pairs]
    if len({S == 1 for _, _, S in shapes}) > 1:
        raise ValueError("int8_linear_group takes scale periods all 1 or all "
                         f"> 1, got {[S for _, _, S in shapes]}")
    K = shapes[0][1]
    x2 = _rows(x, out_dtype, K)
    M = x2.shape[0]
    ys = [torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
          for N, _, _ in shapes]
    n = len(pairs)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    args = (ptrs(*[q.data_ptr() for q, _ in pairs]),
            ptrs(*[s.data_ptr() for _, s in pairs]),
            ptrs(*[y.data_ptr() for y in ys]),
            ints(*[N for N, _, _ in shapes]), ints(*[S for _, _, S in shapes]))
    fn = _kernel_fns()[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x2.data_ptr(), M, K, x2.stride(0), n,
                *(ctypes.addressof(a) for a in args), splits, stream)
    if rc != 0:
        weights = [tuple(q.shape) for q, _ in pairs]
        raise RuntimeError(f"int8_linear launch failed: CUDA error {rc} "
                           f"(x [{M}, {K}], weights {weights})")
    int8_linear.launches += 1
    return tuple(y.view(*x.shape[:-1], y.shape[1]) for y in ys)


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[..., N] in ``out_dtype``; arguments as
    :func:`int8_linear_reference`."""
    if x.device.type == "cuda":
        return _kernel(x, q, scale, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_linear runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    return int8_linear_reference(x, q, scale, out_dtype=out_dtype)


int8_linear.launches = 0


def int8_linear_group(x: torch.Tensor,
                      pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """``x @ W_i.T`` for each ``(q_i, scale_i)`` of ``pairs`` (1 to
    :data:`MAX_GROUP` weights of the same K), as :func:`int8_linear` would
    give them one by one: on the card in one kernel launch, on the CPU
    through :func:`int8_linear_reference` a product at a time."""
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"int8_linear_group takes 1 to {MAX_GROUP} weights, "
                         f"got {len(pairs)}")
    if x.device.type == "cuda":
        return _group_kernel(x, list(pairs), out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_linear_group runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    return tuple(int8_linear_reference(x, q, scale, out_dtype=out_dtype)
                 for q, scale in pairs)


def int8_linear_swiglu_reference(
        x: torch.Tensor, gate: Tuple[torch.Tensor, torch.Tensor],
        up: Tuple[torch.Tensor, torch.Tensor], *,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``silu(x @ Wg.T) * (x @ Wu.T)`` in plain PyTorch: each product as
    :func:`int8_linear_reference` gives it, then
    :func:`~kubeflow_tpu_torch.ops.swiglu.swiglu_reference`."""
    return swiglu_reference(
        int8_linear_reference(x, *gate, out_dtype=out_dtype),
        int8_linear_reference(x, *up, out_dtype=out_dtype))


def _swiglu_kernel(x, gate, up, out_dtype, splits: int = 0):
    """K4 with the SwiGLU epilogue on CUDA tensors (``splits`` as
    :func:`_kernel`'s)."""
    (Ng, K, Sg), (Nu, _, Su) = (_check_weight(q, s, x) for q, s in (gate, up))
    if Ng != Nu or Sg != 1 or Su != 1:
        raise ValueError(f"int8_linear_swiglu takes gate and up weights of "
                         f"one shape with per-row scales, got [{Ng}, {K}] S "
                         f"{Sg} and [{Nu}, {K}] S {Su}")
    x2 = _rows(x, out_dtype, K)
    M = x2.shape[0]
    if M > DECODE_MAX_ROWS:
        raise ValueError(f"int8_linear_swiglu kernel takes at most "
                         f"{DECODE_MAX_ROWS} rows, got {M}")
    h = torch.empty((M, Ng), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _swiglu_fn()(x2.data_ptr(), M, K, x2.stride(0),
                          gate[0].data_ptr(), gate[1].data_ptr(),
                          up[0].data_ptr(), up[1].data_ptr(), h.data_ptr(),
                          Ng, splits, stream)
    if rc != 0:
        raise RuntimeError(f"int8_linear_swiglu launch failed: CUDA error "
                           f"{rc} (x [{M}, {K}], weights [{Ng}, {K}])")
    int8_linear.launches += 1
    int8_linear.swiglu_launches += 1
    return h.view(*x.shape[:-1], Ng)


def int8_linear_swiglu(x: torch.Tensor,
                       gate: Tuple[torch.Tensor, torch.Tensor],
                       up: Tuple[torch.Tensor, torch.Tensor], *,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``silu(x @ Wg.T) * (x @ Wu.T)`` [..., F] of ``gate`` and ``up``,
    each ``(q [F, K] int8, scale [F, 1] bf16)``: on the card one K4 launch
    with the SwiGLU epilogue, for at most :data:`DECODE_MAX_ROWS` rows (or
    ValueError); on the CPU :func:`int8_linear_swiglu_reference`."""
    if x.device.type == "cuda":
        return _swiglu_kernel(x, gate, up, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"int8_linear_swiglu runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    return int8_linear_swiglu_reference(x, gate, up, out_dtype=out_dtype)


int8_linear.swiglu_launches = 0

"""Flash attention: the CUDA kernels and their plain PyTorch versions.

``flash_attention`` / ``flash_attention_lse`` take the model layout
(q [B, Sq, H, D]; k, v [B, Skv, Hkv, D]), are differentiable in q, k and v
(a ``torch.autograd.Function`` that saves q, k, v, o and lse, as the JAX
custom VJP does) and dispatch on where the tensors live:

- CUDA tensors launch the forward kernel ``ops/csrc/flash_attention_fwd.cu``
  (K1) and, in the backward, ``ops/csrc/flash_attention_bwd.cu`` (K2), built
  at first use by ``ops/_build.py``, or raise. There is no fallback on the
  card: the kernels take every shape the model produces (they mask the
  ragged edge themselves) and raise on what they do not take (head_dim
  outside {64, 128}, H % Hkv != 0, a dtype other than bf16/f32).
- CPU tensors take :func:`flash_attention_reference` forward and
  :func:`flash_attention_backward_reference` backward, which compute the
  same functions in plain PyTorch. They are also what ``chip_smoke.py``
  holds the kernels against on the card.

Each forward launch adds one to ``flash_attention.fwd_launches``, each
backward launch (both CUDA kernels of K2) one to
``flash_attention.bwd_launches``.

Offsets follow the JAX wrappers: ``flash_attention``'s ``q_offset`` is 0
when q sits at the END of kv (decode alignment, absolute q row 0 at
Skv - Sq); ``flash_attention_lse`` takes absolute ``q_offset`` and
``kv_offset``, either of which may be a tensor (no host sync; it gets no
gradient). A fully masked row gives o = 0 and lse = ``NEG_INF``, which
``merge_attention_blocks`` drops, and zero gradients.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30          # finite: merges of fully masked blocks stay NaN-free
_FWD_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

IntLike = Union[int, torch.Tensor]


def _block_default(env: str, fallback: int) -> int:
    """KFTPU_FLASH_BLOCK_Q / KFTPU_FLASH_BLOCK_KV override, read per call."""
    v = os.environ.get(env, "")
    if not v:
        return fallback
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{env}={v!r} is not an integer") from None
    if n <= 0:
        raise ValueError(f"{env}={v!r} must be positive (unset it to use "
                         f"the default {fallback})")
    return n


def default_blocks(sq: int, skv: int) -> Tuple[int, int]:
    """The (block_q, block_kv) the JAX wrappers resolve when the caller
    passes nothing, including any KFTPU_FLASH_BLOCK_* override: the
    contract ring attention's path selection reads (a later slice). The
    CUDA kernels tile with their own tiles (K1: 64 or 128 q rows by Sq)
    and take any Sq/Skv, so the blocks select nothing in them."""
    return (min(_block_default("KFTPU_FLASH_BLOCK_Q", 1024), sq),
            min(_block_default("KFTPU_FLASH_BLOCK_KV", 1024), skv))


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, scale: float, offset: IntLike = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (o [B, Sq, H, D] in q.dtype,
    lse [B, H, Sq] f32). ``offset`` is the absolute position of q row 0
    minus that of kv col 0; causal keeps kv col j for q row i iff
    i + offset >= j. Statistics are f32 whatever the input dtype."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if H % Hkv != 0:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 3, 1)                    # [B, Hkv, D, Skv]
    s = torch.matmul(qg.reshape(B, Hkv, G * Sq, D), kf)
    s = s.reshape(B, Hkv, G, Sq, Skv) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + offset
        live = q_pos >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~live, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                       # -inf: fully masked
    dead = torch.isneginf(lse)
    p = torch.exp(s - torch.where(dead, 0.0, lse)[..., None])
    vf = v.float().permute(0, 2, 1, 3)                     # [B, Hkv, Skv, D]
    o = torch.matmul(p.reshape(B, Hkv, G * Sq, Skv), vf)
    o = o.reshape(B, Hkv, G, Sq, D).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    lse = torch.where(dead, NEG_INF, lse).reshape(B, H, Sq)
    return o.to(q.dtype), lse


def _offset_tensor(off: IntLike, device: torch.device) -> torch.Tensor:
    """The causal offset as a [1] int32 tensor on the kernel's device.
    An int becomes a device fill (no host->device copy, no sync)."""
    if isinstance(off, torch.Tensor):
        return off.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(off), dtype=torch.int32, device=device)


def _check_kernel_inputs(q, k, v) -> None:
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {D}")
    if H % Hkv != 0:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes bf16 or f32 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"for q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        _check_aligned(name, t)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
        # The bf16 kernels move rows with 16-byte loads.
        raise ValueError(f"{name} must be 16-byte aligned with strides "
                         "a multiple of 8 elements (call .contiguous())")


@functools.lru_cache(maxsize=None)
def _fwd_kernel_fn():
    """K1's C entry point with its ctypes signature, built and loaded at
    first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    fn = load_library(_FWD_SOURCE).kftpu_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def bind_bwd(lib: ctypes.CDLL):
    """K2's C entry point in a loaded build of ``flash_attention_bwd.cu``,
    with its ctypes signature (``kernel_ab.py`` binds other builds)."""
    fn = lib.kftpu_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fn():
    """K2's C entry point, built and loaded at first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    return bind_bwd(load_library(_BWD_SOURCE))


def _kernel(q, k, v, off: torch.Tensor, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward kernel (K1) on PyTorch's current stream."""
    _check_kernel_inputs(q, k, v)
    fn = _fwd_kernel_fn()
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KERNEL_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(), off.data_ptr(),
                B, H, Hkv, Sq, Skv,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc} (shapes q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    flash_attention.fwd_launches += 1
    return o, lse


def _bwd_kernel(q, k, v, do, lse, delta, off: torch.Tensor, causal: bool,
                scale: float) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch the CUDA backward kernel (K2: its dk/dv and dq kernels) on
    PyTorch's current stream. ``delta`` = rowsum(do * o) - dlse,
    [B, H, Sq] f32."""
    _check_kernel_inputs(q, k, v)
    _check_aligned("do", do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    fn = _bwd_kernel_fn()
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    strides = (ctypes.c_longlong * 21)(*(
        st for t in (q, k, v, do, dq, dk, dv) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_KERNEL_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), off.data_ptr(),
                B, H, Hkv, Sq, Skv, ctypes.addressof(strides), float(scale),
                int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc} (shapes q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


def _delta(o: torch.Tensor, do: torch.Tensor,
           dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """delta = rowsum(do * o) - dlse, [B, H, Sq] f32: the backward's row
    term, computed outside the kernel as the JAX wrapper computes it."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor] = None,
    *, causal: bool, scale: float, offset: IntLike = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, written out from its
    formulas (not through autograd): p = exp(s - lse); dv = p^T do;
    dp = do v^T; ds = p (dp - delta) with delta = rowsum(do o) - dlse;
    dk = ds^T q scale; dq = ds k scale. dk and dv sum over the G query heads
    of their kv head. Statistics are f32; the grads come back in the
    inputs' dtypes. Masked pairs and fully masked rows (lse = NEG_INF) give
    p = 0, so their grads are exactly 0."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv

    def grouped(x):                                 # -> [B, Hkv, G, Sq, D]
        return x.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)

    qf, dof = grouped(q), grouped(do)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, Skv, D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + offset
        live = q_pos >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq)[..., None])
    delta = _delta(o, do, dlse).reshape(B, Hkv, G, Sq)[..., None]
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _on_device(q: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    plain versions); anything else raises."""
    if q.device.type in ("cuda", "cpu"):
        return q.device.type == "cuda"
    raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (plain "
                     f"version), not {q.device}")


class _FlashAttention(torch.autograd.Function):
    """(o, lse) of q, k, v with the flash backward. Saves q, k, v, o and
    lse, as the JAX custom VJP saves its residuals; lse's cotangent folds
    into delta (the ``flash_attention_lse`` path)."""

    @staticmethod
    def forward(ctx, q, k, v, offset, causal, scale):
        if _on_device(q):
            o, lse = _kernel(q, k, v, _offset_tensor(offset, q.device),
                             causal, scale)
        else:
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               scale=scale, offset=offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.offset, ctx.causal, ctx.scale = offset, causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if do is None and dlse is None:
            return (None,) * 6
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do
        if _on_device(q):
            dq, dk, dv = _bwd_kernel(
                q, k, v, do.contiguous(), lse, _delta(o, do, dlse),
                _offset_tensor(ctx.offset, q.device), ctx.causal, ctx.scale)
        else:
            dq, dk, dv = flash_attention_backward_reference(
                q, k, v, o, lse, do, dlse, causal=ctx.causal,
                scale=ctx.scale, offset=ctx.offset)
        return dq, dk, dv, None, None, None


def _attention(q, k, v, *, causal: bool, scale: Optional[float],
               offset: IntLike) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return _FlashAttention.apply(q, k, v, offset, causal, scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: IntLike = 0,
) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Skv, Hkv, D] -> [B, Sq, H, D].
    ``q_offset`` follows mha_reference's convention: 0 means q starts at
    absolute position Skv - Sq. The JAX wrapper's ``block_q``/``block_kv``
    have no counterpart: the kernels' tiles are their own."""
    Sq, Skv = q.shape[1], k.shape[1]
    o, _ = _attention(q, k, v, causal=causal, scale=scale,
                      offset=q_offset + (Skv - Sq))
    return o


flash_attention.fwd_launches = 0
flash_attention.bwd_launches = 0


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: IntLike = 0,
    kv_offset: IntLike = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, H, D], lse [B, H, Sq] f32) for blockwise composition:
    offsets are ABSOLUTE positions of q[0] / k[0]. Unlike the JAX wrapper
    this never returns None: every shape is taken (kernels on CUDA, plain
    versions on CPU). o is normalized per block; merge blocks with
    :func:`merge_attention_blocks`. Both outputs are differentiable: lse's
    cotangent enters the backward as ``dlse``."""
    return _attention(q, k, v, causal=causal, scale=scale,
                      offset=q_offset - kv_offset)


def merge_attention_blocks(
    o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
    lse2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine two normalized partial attentions over disjoint kv blocks.
    o: [B, S, H, D]; lse: [B, H, S]. Fully masked blocks carry
    lse = NEG_INF and zero o, so they drop out of the weighted sum."""
    lse_new = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse_new).permute(0, 2, 1)[..., None]
    w2 = torch.exp(lse2 - lse_new).permute(0, 2, 1)[..., None]
    o = o1.float() * w1 + o2.float() * w2
    return o.to(o1.dtype), lse_new

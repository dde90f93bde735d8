"""Flash attention: the CUDA forward kernel and its plain PyTorch version.

``flash_attention`` / ``flash_attention_lse`` take the model layout
(q [B, Sq, H, D]; k, v [B, Skv, Hkv, D]) and dispatch on where the tensors
live:

- CUDA tensors launch ``ops/csrc/flash_attention_fwd.cu`` (built at first
  use by ``ops/_build.py``) or raise. There is no fallback on the card:
  the kernel takes every shape the serving path produces (it masks the
  ragged edge itself) and raises on what it does not take (head_dim
  outside {64, 128}, H % Hkv != 0, a dtype other than bf16/f32, inputs
  that require grad).
- CPU tensors take :func:`flash_attention_reference`, which computes the
  same function in plain PyTorch. It is also what ``chip_smoke.py`` holds
  the kernel against on the card.

Each launch adds one to ``flash_attention.fwd_launches``.

Offsets follow the JAX wrappers: ``flash_attention``'s ``q_offset`` is 0
when q sits at the END of kv (decode alignment, absolute q row 0 at
Skv - Sq); ``flash_attention_lse`` takes absolute ``q_offset`` and
``kv_offset``, either of which may be a tensor. A fully masked row gives
o = 0 and lse = ``NEG_INF``, which ``merge_attention_blocks`` drops.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30          # finite: merges of fully masked blocks stay NaN-free
_KERNEL_SOURCE = "flash_attention_fwd.cu"
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
    CUDA kernel tiles with its own fixed 64 x 64 tiles and takes any
    Sq/Skv, so the blocks select nothing in it."""
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: the backward kernel "
            "(kubeflow_tpu/ops/flash_attention.py::_bwd_kernel, K2) is "
            "ported with the training slice; run under torch.no_grad()")
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
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            # The bf16 kernel moves rows with 16-byte loads.
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             "a multiple of 8 elements (call .contiguous())")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point with its ctypes signature, built and
    loaded at first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    fn = load_library(_KERNEL_SOURCE).kftpu_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _kernel(q, k, v, off: torch.Tensor, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA forward kernel on PyTorch's current stream."""
    _check_kernel_inputs(q, k, v)
    fn = _kernel_fn()
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


def _forward(q, k, v, *, causal: bool, scale: Optional[float],
             offset: IntLike) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    if q.device.type == "cuda":
        return _kernel(q, k, v, _offset_tensor(offset, q.device), causal,
                       scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         offset=offset)
    raise ValueError(f"flash_attention runs on cuda (kernel) or cpu (plain "
                     f"version), not {q.device}")


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
    have no counterpart: the kernel's tiles are its own."""
    Sq, Skv = q.shape[1], k.shape[1]
    o, _ = _forward(q, k, v, causal=causal, scale=scale,
                    offset=q_offset + (Skv - Sq))
    return o


flash_attention.fwd_launches = 0


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
    this never returns None: every shape is taken (kernel on CUDA, plain
    version on CPU). o is normalized per block; merge blocks with
    :func:`merge_attention_blocks`."""
    return _forward(q, k, v, causal=causal, scale=scale,
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

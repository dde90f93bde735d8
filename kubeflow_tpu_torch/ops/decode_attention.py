"""Decode attention: the CUDA kernel (K3) and its plain PyTorch version.

:func:`decode_attention` attends one query row per slot (q [B, 1, H, D])
against the dense KV cache (k, v [B, L, Hkv, D], bf16, or int8 with f32
``k_scale``/``v_scale`` [B, L, Hkv, 1]) up to each slot's ``cache_index``
(a device tensor), and, when staged, against the chunk's staging rows
``0..stage_step``. It dispatches on where the tensors live:

- CUDA tensors launch ``ops/csrc/decode_attention.cu``, built at first use
  by ``ops/_build.py``, or raise: the kernel takes bf16 q and staging
  rows, a bf16 or int8 cache, head_dim 64 or 128 and query groups
  H / Hkv of 1, 2, 4 or 8. One launch a call: the blocks of a (slot, kv
  head) form a thread-block cluster whose size depends only on the shapes
  (:func:`launch_cluster`; so one captured CUDA graph serves every
  length), split the slot's live rows among themselves on the device,
  read them with TMA, multiply on the tensor cores (bf16 operands, f32
  accumulators) and merge through distributed shared memory. It reads
  only the live rows and writes bf16. It is capture-safe (no host read of
  the lengths, no allocation in the C code, the caller's stream) and
  deterministic.
- CPU tensors take :func:`kubeflow_tpu_torch.ops.attention.
  decode_attention_reference`, which computes the same function in plain
  PyTorch (and also takes several query rows, unstaged). It is also what
  ``chip_smoke.py`` holds the kernel against on the card.

With ``block_tables`` [B, max_blocks] int32 (the paged pool of
``ops/paged_attention.py``), k and v (and the int8 scales) are pools
[P + 1, block_size, Hkv, .] and slot b's logical row r lives on page
``block_tables[b, r // block_size]``; the logical length is ``max_blocks
* block_size``. The kernel reads the pool in place through the table
(a device tensor, so one captured graph serves every table) and takes
block sizes that are a multiple of 16; it splits the rows as a dense
call over the same logical length does, so the two are bitwise equal.
The CPU path gathers the pages into dense order and runs the plain
version (:func:`~kubeflow_tpu_torch.ops.paged_attention.gather_cache`).

Each kernel call adds one to ``decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from kubeflow_tpu_torch.ops.attention import decode_attention_reference
from kubeflow_tpu_torch.ops.paged_attention import gather_cache

_SOURCE = "decode_attention.cu"
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
#: The kernel shares a slot's live rows among a cluster's blocks in
#: chunks of this many rows (its TMA box).
CHUNK_ROWS = 16
#: The portable thread-block cluster size.
MAX_CLUSTER = 8


def split_plan(max_len: int) -> int:
    """Blocks a (slot, kv head) is split over (one cluster) for a cache of
    ``max_len`` rows: a function of ``max_len`` alone, so a captured graph
    serves any length, and no more blocks than a full cache has chunks.
    The kernel gives block r chunks [r p + min(r, e), ...) of the slot's
    ceil(live / 16), p = chunks // blocks and e = chunks % blocks."""
    return max(1, min(MAX_CLUSTER, -(-max_len // CHUNK_ROWS)))


def bind(lib: ctypes.CDLL):
    """K3's C entry points in ``lib`` with their ctypes signatures: the
    launch, and the cluster size it picks for (head_dim, group, int8, B,
    Hkv, most blocks)."""
    fn = lib.kftpu_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    cluster = lib.kftpu_decode_attention_cluster
    cluster.restype = ctypes.c_int
    cluster.argtypes = [ctypes.c_int] * 6
    return fn, cluster


def bind_paged(lib: ctypes.CDLL):
    """K3's paged C entry in ``lib`` with its ctypes signature."""
    fn = lib.kftpu_decode_attention_paged
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """K3's C entry points, built and loaded at first use."""
    from kubeflow_tpu_torch.ops._build import load_library

    lib = load_library(_SOURCE)
    return bind(lib) + (bind_paged(lib),)


def launch_cluster(head_dim: int, group: int, kv_int8: bool, batch: int,
                   kv_heads: int, max_len: int) -> int:
    """Blocks a (slot, kv head) is split over when the kernel runs at these
    shapes on the current card: ``split_plan(max_len)``, or fewer where
    ``batch * kv_heads`` clusters of that size would not all be resident at
    once."""
    n = _kernel_fns()[1](head_dim, group, int(kv_int8), batch, kv_heads,
                         split_plan(max_len))
    if n < 1:
        raise RuntimeError(f"decode_attention plan failed: CUDA error {-n}")
    return n


def _check_rows(name: str, t: torch.Tensor, device: torch.device,
                strides: Tuple[int, ...]) -> None:
    """Head dim contiguous; base and strides 16-byte aligned, as the
    kernel's 16-byte loads and TMA's tensor maps need."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    per = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % per for st in strides):
        raise ValueError(f"{name} must be 16-byte aligned with strides "
                         f"a multiple of {per} elements")


def _check_tables(tables: torch.Tensor, block_size: int, k: torch.Tensor,
                  B: int) -> int:
    """The paged call's table and pool geometry; returns the logical
    length max_blocks x block_size."""
    if block_size % CHUNK_ROWS or block_size < CHUNK_ROWS:
        raise ValueError(f"decode_attention kernel takes a pool block size "
                         f"that is a multiple of {CHUNK_ROWS} (a chunk stays "
                         f"on one page), got {block_size}")
    if k.shape[1] != block_size:
        raise ValueError(f"pool pages hold {k.shape[1]} rows, block_size is "
                         f"{block_size}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != B or tables.device != k.device \
            or not tables.is_contiguous():
        raise ValueError(f"block_tables must be contiguous int32 [B, "
                         f"max_blocks] on {k.device}, got "
                         f"{tuple(tables.shape)} {tables.dtype}")
    return tables.shape[1] * block_size


def _kernel(q, k, v, cache_index, k_scale, v_scale, stage_key, stage_value,
            stage_step, tables=None, block_size=0) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    paged = tables is not None
    L = _check_tables(tables, block_size, k, B) if paged else k.shape[1]
    if Sq != 1:
        raise ValueError(f"decode_attention kernel takes one query row per "
                         f"slot, got {Sq}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {D}")
    if H % Hkv or H // Hkv not in _GROUPS:
        raise ValueError(f"decode_attention kernel takes query groups "
                         f"{_GROUPS}, got {H} heads over {Hkv}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention kernel takes bf16 q, got "
                         f"{q.dtype}")
    quant = k.dtype == torch.int8
    if k.dtype not in (torch.bfloat16, torch.int8) or v.dtype != k.dtype:
        raise ValueError(f"decode_attention kernel takes a bf16 or int8 "
                         f"cache, got {k.dtype}/{v.dtype}")
    if k.shape != v.shape or (k.shape[0] != B and not paged) \
            or k.shape[3] != D or k.stride() != v.stride():
        raise ValueError(f"bad cache shapes/strides {tuple(k.shape)}/"
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    if quant != (k_scale is not None) or (v_scale is None) != (k_scale
                                                                is None):
        raise ValueError("an int8 cache needs k_scale and v_scale, a bf16 "
                         "one neither")
    _check_rows("q", q, q.device, (q.stride(0), q.stride(2)))
    for name, t in (("k", k), ("v", v)):
        _check_rows(name, t, q.device, t.stride()[:3])
    scale_strides = (0, 0, 0)
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k.shape[:3] + (1,) \
                    or s.device != q.device:
                raise ValueError(f"{name} must be f32 {tuple(k.shape[:3])}"
                                 f" + (1,) on {q.device}")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("k_scale and v_scale strides differ")
        scale_strides = k_scale.stride()[:3]
    staged = stage_key is not None
    stage_strides = (0, 0, 0)
    stage_rows = 0
    if staged:
        C = stage_key.shape[1]
        if stage_step is None or not 0 <= int(stage_step) < C:
            raise ValueError(f"stage_step {stage_step} outside the {C} "
                             "staging rows")
        if stage_key.dtype != torch.bfloat16 or stage_value is None \
                or stage_value.dtype != torch.bfloat16 \
                or stage_key.shape != (B, C, Hkv, D) \
                or stage_value.shape != stage_key.shape \
                or stage_key.stride() != stage_value.stride():
            raise ValueError("staging rows must be bf16 [B, C, Hkv, D] "
                             "pairs of one layout")
        for name, t in (("stage_key", stage_key),
                        ("stage_value", stage_value)):
            _check_rows(name, t, q.device, t.stride()[:3])
        stage_strides = stage_key.stride()[:3]
        stage_rows = int(stage_step) + 1
    lengths = cache_index.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (B,):
        raise ValueError(f"cache_index must be [B], got "
                         f"{tuple(lengths.shape)}")
    o = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 11)(
        q.stride(0), q.stride(2), *k.stride()[:3], *scale_strides,
        *stage_strides)
    fns = _kernel_fns()
    head = (D, H // Hkv, int(quant), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, lengths.data_ptr())
    stage = (stage_key.data_ptr() if staged else None,
             stage_value.data_ptr() if staged else None, stage_rows,
             stage_key.shape[1] if staged else 0, o.data_ptr(), B, Hkv)
    with torch.cuda.device(q.device):
        tail = (split_plan(L), ctypes.addressof(strides), float(D ** -0.5),
                torch.cuda.current_stream(q.device).cuda_stream)
        if paged:
            rc = fns[2](*head, tables.data_ptr(), tables.shape[1],
                        block_size, k.shape[0], *stage, *tail)
        else:
            rc = fns[0](*head, *stage, L, *tail)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc} "
                           f"(q {tuple(q.shape)}, cache {tuple(k.shape)} "
                           f"{k.dtype}, staged {staged}, paged {paged})")
    decode_attention.launches += 1
    return o


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_index: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    stage_key: Optional[torch.Tensor] = None,
    stage_value: Optional[torch.Tensor] = None,
    stage_step: Optional[int] = None,
    block_tables: Optional[torch.Tensor] = None,
    block_size: int = 0,
) -> torch.Tensor:
    """[B, Sq, H, D] in q's dtype; arguments as
    :func:`~kubeflow_tpu_torch.ops.attention.decode_attention_reference`
    (the kernel takes Sq == 1), and with ``block_tables`` over a paged
    pool of ``block_size``-row pages (see the module's docstring)."""
    if q.device.type == "cuda":
        return _kernel(q, k, v, cache_index, k_scale, v_scale, stage_key,
                       stage_value, stage_step, block_tables, block_size)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device}")
    if block_tables is not None:
        k, v, k_scale, v_scale = gather_cache(block_tables, block_size, k, v,
                                              k_scale, v_scale)
    return decode_attention_reference(
        q, k, v, cache_index, k_scale=k_scale, v_scale=v_scale,
        stage_key=stage_key, stage_value=stage_value, stage_step=stage_step)


decode_attention.launches = 0

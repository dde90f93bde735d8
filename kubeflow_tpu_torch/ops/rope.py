"""Rotary position embeddings (split-half convention, Llama-style): the CUDA
kernel (K7) and its plain PyTorch version.

:func:`apply_rope_qk` rotates q and k in one call and :func:`apply_rope`
one tensor, both through a ``torch.autograd.Function`` whose backward is
the inverse rotation (the transpose of a rotation), written out rather
than replayed op by op. :func:`apply_rope_fused` takes the fused q/k/v
projection [B, S, Hkv, G + 2, D] (``LlamaConfig.fused_qkv``) and returns
q and k rotated, contiguous, and v, a contiguous copy of its slot where a
gradient is needed and a view of it otherwise: K7 reads q and k in place
(the strided mode); its backward writes dq and dk into their slots of one
[B, S, Hkv, G + 2, D] gradient and copies dv into the last, with no
zero-fill. They dispatch on where the tensors live:

- CUDA tensors launch ``ops/csrc/rope.cu``, built at first use by
  ``ops/_build.py``, or raise: q and k bf16 or f32 of one dtype, head dim
  a multiple of 16 and contiguous, every row 16-byte aligned (views of a
  fused projection are read in place); positions int32 or int64; cos and
  sin f32 [L, D/2]. One launch a call for q and k together, forward or
  backward, on the current stream and capture-safe (the positions are
  read and clamped on the device).
- CPU tensors take :func:`rope_reference`, which is also what the card
  holds the kernel against; kernel and plain version round alike, so
  they agree bitwise.

A staged decode step (:func:`rope_stage`, :func:`rope_stage_fused`) also
writes its staging rows in the same launch: q rotated into its output, k
rotated straight into column ``stage_step`` of ``stage_key`` and v copied
into that column of ``stage_value``, as the JAX model's step writes them
with ``dynamic_update_slice_in_dim``. Its plain version
(:func:`rope_stage_reference`) is :func:`rope_reference` on q and k and
the two slice writes, and the kernel agrees with it bitwise.

Each forward launch adds one to ``apply_rope.fwd_launches`` (the staged
mode's too: one a layer a pass), each backward launch to
``apply_rope.bwd_launches``, and each staged launch to
``apply_rope.stage_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_SOURCE = "rope.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rope_frequencies(
    head_dim: int, max_len: int, *, theta: float = 10000.0,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin), each [max_len, head_dim // 2], in f32."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def _positions(x: torch.Tensor, positions: Optional[torch.Tensor]):
    B, S = x.shape[:2]
    if positions is None:
        return torch.arange(S, device=x.device).expand(B, S)
    return positions


def rope_reference(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
    positions: Optional[torch.Tensor] = None, inverse: bool = False,
) -> torch.Tensor:
    """x: [B, S, H, D] rotated by its positions [B, S] (arange when None),
    in plain PyTorch; ``inverse`` rotates by minus the angle (the
    backward). Positions past the table are CLAMPED to its last row, as a
    JAX gather clamps them: the serving engine's chained decode dispatches
    feed speculative positions past max_len, and an unclamped index on a
    CUDA tensor is a device-side assert that kills the process."""
    positions = _positions(x, positions).long().clamp(0, cos.shape[0] - 1)
    c = cos[positions][:, :, None, :]          # [B, S, 1, D/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if inverse:
        out = torch.cat([x1 * c + x2 * s, x2 * c - x1 * s], dim=-1)
    else:
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def bind(lib: ctypes.CDLL):
    """K7's C entry point with its ctypes signature."""
    fn = lib.kftpu_rope
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn


def bind_stage(lib: ctypes.CDLL):
    """K7's staged-decode C entry point with its ctypes signature."""
    fn = lib.kftpu_rope_stage
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


@functools.lru_cache(maxsize=None)
def _stage_fn():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind_stage(load_library(_SOURCE))


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"apply_rope runs on cuda (kernel) or cpu (plain "
                     f"version), not {x.device}")


def _grouped(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel's [B, S, H / G, G, D] view: a 4-D [B, S, H, D] view is
    one group a head (G = 1)."""
    return t.unsqueeze(3) if t.dim() == 4 else t


def _check_view(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    per = 16 // q.element_size()
    if t.dtype != q.dtype or t.device != q.device:
        raise ValueError(f"{name} {t.dtype} on {t.device} does not match q "
                         f"{q.dtype} on {q.device}")
    if t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(st % per for st in t.stride()[:-1] if st):
        raise ValueError(f"{name}'s head dim must be contiguous and its "
                         f"rows 16-byte aligned")


def _check(q, k, cos, sin, positions) -> None:
    """q, k: [B, S, H / G, G, D] views (:func:`_grouped`)."""
    if q.dim() != 5 or q.dtype not in _DTYPES:
        raise ValueError(f"apply_rope kernel takes bf16 or f32 [B, S, H, D], "
                         f"got {tuple(q.shape)} {q.dtype}")
    B, S, D = q.shape[0], q.shape[1], q.shape[-1]
    if D % 16 or cos.shape != (cos.shape[0], D // 2) \
            or sin.shape != cos.shape:
        raise ValueError(f"apply_rope kernel takes a head dim that is a "
                         f"multiple of 16 and cos, sin [L, D/2]; got D {D}, "
                         f"cos {tuple(cos.shape)}, sin {tuple(sin.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous f32 on {q.device}")
    if positions.shape != (B, S) or positions.device != q.device \
            or positions.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"positions must be int32 or int64 [{B}, {S}] on "
                         f"{q.device}, got {tuple(positions.shape)} "
                         f"{positions.dtype}")
    for name, t in (("q", q), ("k", k)):
        if t is None:
            continue
        if t.dim() != 5 or t.shape[:2] != (B, S) or t.shape[-1] != D:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
        _check_view(name, t, q)


def _launch(q, k, qo, ko, cos, sin, positions, inverse: bool) -> None:
    """Rotate the [B, S, H / G, G, D] views q (and k, when given) into the
    views qo (and ko) of the same shapes."""
    _check(q, k, cos, sin, positions)
    for name, t, src in (("qo", qo, q), ("ko", ko, k)):
        if src is not None:
            if t.shape != src.shape:
                raise ValueError(f"{name} {tuple(t.shape)} does not match "
                                 f"{tuple(src.shape)}")
            _check_view(name, t, q)
    B, S, D = q.shape[0], q.shape[1], q.shape[-1]

    def heads(t):
        return 0 if t is None else t.shape[2] * t.shape[3]

    st = [*q.stride()[:4], *qo.stride()[:4]]
    st += [0] * 8 if k is None else [*k.stride()[:4], *ko.stride()[:4]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel_fn()(
            _DTYPES[q.dtype], int(positions.dtype == torch.int64),
            int(inverse), q.data_ptr(), 0 if k is None else k.data_ptr(),
            qo.data_ptr(), 0 if ko is None else ko.data_ptr(),
            B, S, heads(q), heads(k), D, (ctypes.c_longlong * 16)(*st),
            q.shape[3], 1 if k is None else k.shape[3], positions.data_ptr(),
            *positions.stride(), cos.data_ptr(), sin.data_ptr(),
            cos.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"apply_rope launch failed: CUDA error {rc} "
                           f"(q {tuple(q.shape)} {q.dtype})")
    if inverse:
        apply_rope.bwd_launches += 1
    else:
        apply_rope.fwd_launches += 1


def _kernel(q, k, cos, sin, positions, inverse: bool):
    """(q', k') of [B, S, H, D] views into new contiguous tensors."""
    qo = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ko = None if k is None else torch.empty(k.shape, dtype=k.dtype,
                                            device=k.device)
    _launch(_grouped(q), None if k is None else _grouped(k), _grouped(qo),
            None if ko is None else _grouped(ko), cos, sin, positions,
            inverse)
    return qo, ko


def _kernel_layout(g: torch.Tensor) -> torch.Tensor:
    """An incoming gradient as the kernel reads it: itself when its head
    dim is contiguous and its rows 16-byte aligned (the flash backward's
    grads are), else a contiguous copy (the plain attention's dk comes
    transposed out of its product)."""
    per = 16 // g.element_size()
    if g.device.type == "cuda" and (
            g.stride(3) != 1 or g.data_ptr() % 16
            or any(st % per for st in g.stride()[:3])):
        return g.contiguous()
    return g


def _rotate(q, k, cos, sin, positions, inverse: bool):
    if _on_card(q):
        return _kernel(q, k, cos, sin, positions, inverse)
    rot = functools.partial(rope_reference, cos=cos, sin=sin,
                            positions=positions, inverse=inverse)
    return rot(q), None if k is None else rot(k)


class _RoPE(torch.autograd.Function):
    """q' of q, or (q', k') of (q, k) when k is given. Saves the tables and
    the positions."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, positions):
        ctx.save_for_backward(cos, sin, positions)
        qo, ko = _rotate(q, k, cos, sin, positions, inverse=False)
        return qo if k is None else (qo, ko)

    @staticmethod
    def backward(ctx, dq, dk=None):
        cos, sin, positions = ctx.saved_tensors
        dq, dk = (None if g is None else _kernel_layout(g) for g in (dq, dk))
        gq, gk = _rotate(dq, dk, cos, sin, positions, inverse=True)
        return gq, gk, None, None, None


def _fused_slots(qkv: torch.Tensor):
    """The [B, S, Hkv, G, D] q slots and the [B, S, Hkv, 1, D] k slot of a
    fused [B, S, Hkv, G + 2, D] projection (or its gradient)."""
    G = qkv.shape[3] - 2
    return qkv[..., :G, :], qkv[..., G:G + 1, :]


def _rotate_fused(qkv, cos, sin, positions):
    """q' [B, S, Hkv * G, D] and k' [B, S, Hkv, D] of the fused projection
    qkv, rotated and contiguous (q and k read in place on the card)."""
    B, S, Hkv, G2, D = qkv.shape
    qs, ks = _fused_slots(qkv)
    if not _on_card(qkv):
        return _rotate(qs.reshape(B, S, -1, D), ks[..., 0, :], cos, sin,
                       positions, inverse=False)
    qo = torch.empty((B, S, Hkv * (G2 - 2), D), dtype=qkv.dtype,
                     device=qkv.device)
    ko = torch.empty((B, S, Hkv, D), dtype=qkv.dtype, device=qkv.device)
    _launch(qs, ks, qo.view(qs.shape), ko.unsqueeze(3), cos, sin, positions,
            inverse=False)
    return qo, ko


class _RoPEFused(torch.autograd.Function):
    """(q', k', v) of the fused projection qkv [B, S, Hkv, G + 2, D]: q'
    and k' as :func:`_rotate_fused` gives them, v a contiguous copy of
    slot G + 1 (a view would keep the whole product alive wherever v is
    saved). Saves the tables and the positions."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, positions):
        ctx.save_for_backward(cos, sin, positions)
        qo, ko = _rotate_fused(qkv, cos, sin, positions)
        return qo, ko, qkv[..., -1, :].contiguous()

    @staticmethod
    def backward(ctx, dq, dk, dv):
        cos, sin, positions = ctx.saved_tensors
        B, S, H, D = dq.shape
        Hkv = dk.shape[2]
        dqkv = torch.empty((B, S, Hkv, H // Hkv + 2, D), dtype=dq.dtype,
                           device=dq.device)
        dqs, dks = _fused_slots(dqkv)
        if _on_card(dq):
            dq, dk = _kernel_layout(dq), _kernel_layout(dk)
            _launch(dq.view(dqs.shape), dk.unsqueeze(3), dqs, dks, cos, sin,
                    positions, inverse=True)
        else:
            gq, gk = _rotate(dq, dk, cos, sin, positions, inverse=True)
            dqs.copy_(gq.view(dqs.shape))
            dks.copy_(gk.unsqueeze(3))
        dqkv[..., -1, :].copy_(dv)
        return dqkv, None, None, None


def apply_rope_fused(
    qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v) of the fused projection qkv [B, S, Hkv, G + 2, D] (rows
    ordered kv head, slot, d; q is slots 0..G-1, k slot G, v slot G + 1):
    q [B, S, Hkv * G, D] and k [B, S, Hkv, D] rotated by the positions
    [B, S] (arange when None), contiguous, in one kernel launch on the
    card; v [B, S, Hkv, D] a contiguous copy where qkv needs a gradient,
    else a view of its slot (the attention kernels read strided views)."""
    if qkv.dim() != 5 or qkv.shape[3] < 3:
        raise ValueError(f"apply_rope_fused takes [B, S, Hkv, G + 2, D], got "
                         f"{tuple(qkv.shape)}")
    positions = _positions(qkv, positions)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _RoPEFused.apply(qkv, cos, sin, positions)
    return (*_rotate_fused(qkv, cos, sin, positions), qkv[..., -1, :])


def apply_rope_qk(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    *, positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D] and k [B, S, Hkv, D] rotated by the same positions
    [B, S] (arange when None), in one kernel launch on the card."""
    return _RoPE.apply(q, k, cos, sin, _positions(q, positions))


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: [B, S, H, D]. positions: [B, S] absolute positions (defaults to
    arange), clamped to the table (see :func:`rope_reference`)."""
    return _RoPE.apply(x, None, cos, sin, _positions(x, positions))


def rope_stage_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
    sin: torch.Tensor, positions: torch.Tensor, stage_key: torch.Tensor,
    stage_value: torch.Tensor, stage_step: int,
) -> torch.Tensor:
    """The staged decode step's RoPE in plain PyTorch: q [B, 1, H, D]
    rotated (returned), k [B, 1, Hkv, D] rotated into column
    ``stage_step`` of ``stage_key`` [B, C, Hkv, D] and v copied into that
    column of ``stage_value``, both in place and in their dtype."""
    q = rope_reference(q, cos, sin, positions=positions)
    k = rope_reference(k, cos, sin, positions=positions)
    stage_key[:, stage_step:stage_step + 1] = k.to(stage_key.dtype)
    stage_value[:, stage_step:stage_step + 1] = v.to(stage_value.dtype)
    return q


def _check_stage(name: str, t: torch.Tensor, q: torch.Tensor, k) -> None:
    """A staging tensor [B, C, Hkv, D] as the kernel writes it."""
    B, D, Hkv = q.shape[0], q.shape[-1], k.shape[2] * k.shape[3]
    if t.dim() != 4 or t.shape[0] != B or t.shape[2:] != (Hkv, D):
        raise ValueError(f"{name} {tuple(t.shape)} is not [{B}, C, {Hkv}, "
                         f"{D}]")
    _check_view(name, t, q)


def _stage_launch(q, k, v, cos, sin, positions, stage_key, stage_value,
                  stage_step: int) -> torch.Tensor:
    """The staged mode on the card: q, k, v as [B, 1, H / G, G, D] views
    (:func:`_grouped`); returns q' [B, 1, H, D], contiguous."""
    _check(q, k, cos, sin, positions)
    _check_view("v", v, q)
    if v.dim() != 5 or v.shape[:2] != k.shape[:2] \
            or v.shape[2] * v.shape[3] != k.shape[2] * k.shape[3] \
            or v.shape[-1] != q.shape[-1]:
        raise ValueError(f"v {tuple(v.shape)} does not match k "
                         f"{tuple(k.shape)}")
    for name, t in (("stage_key", stage_key), ("stage_value", stage_value)):
        _check_stage(name, t, q, k)
    B, D = q.shape[0], q.shape[-1]
    Hq, Hkv = q.shape[2] * q.shape[3], k.shape[2] * k.shape[3]
    qo = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in (t.stride(0), *t.stride()[2:4])]
    stage_strides = [*stage_key.stride()[:3], *stage_value.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _stage_fn()(
            _DTYPES[q.dtype], int(positions.dtype == torch.int64),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qo.data_ptr(),
            stage_key.data_ptr(), stage_value.data_ptr(), B, Hq, Hkv, D,
            (ctypes.c_longlong * 9)(*strides), q.shape[3], k.shape[3],
            v.shape[3], (ctypes.c_longlong * 6)(*stage_strides),
            stage_key.shape[1], stage_step, positions.data_ptr(),
            positions.stride(0), cos.data_ptr(), sin.data_ptr(),
            cos.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"rope_stage launch failed: CUDA error {rc} "
                           f"(q {tuple(q.shape)} {q.dtype})")
    apply_rope.fwd_launches += 1
    apply_rope.stage_launches += 1
    return qo


def _stage_step(stage_key: torch.Tensor, stage_step: int) -> int:
    C = stage_key.shape[1]
    if isinstance(stage_step, bool) or not isinstance(stage_step, int) \
            or not 0 <= stage_step < C:
        raise ValueError(f"stage_step {stage_step!r} is not a column of the "
                         f"{C} staging rows")
    return stage_step


def rope_stage(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
    sin: torch.Tensor, positions: torch.Tensor, stage_key: torch.Tensor,
    stage_value: torch.Tensor, stage_step: int,
) -> torch.Tensor:
    """A staged decode step's RoPE and staging writes: q [B, 1, H, D]
    rotated by positions [B, 1] (returned, contiguous), k [B, 1, Hkv, D]
    rotated into column ``stage_step`` (a host int) of ``stage_key`` [B,
    C, Hkv, D] and v copied into that column of ``stage_value``, in place;
    one kernel launch on the card, :func:`rope_stage_reference` on the
    CPU."""
    stage_step = _stage_step(stage_key, stage_step)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"rope_stage takes one token a row, q [B, 1, H, D]; "
                         f"got {tuple(q.shape)}")
    if not _on_card(q):
        return rope_stage_reference(q, k, v, cos, sin, positions, stage_key,
                                    stage_value, stage_step)
    return _stage_launch(_grouped(q), _grouped(k), _grouped(v), cos, sin,
                         positions, stage_key, stage_value, stage_step)


def rope_stage_fused(
    qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: torch.Tensor, stage_key: torch.Tensor,
    stage_value: torch.Tensor, stage_step: int,
) -> torch.Tensor:
    """:func:`rope_stage` of the fused projection qkv [B, 1, Hkv, G + 2, D]
    (q slots 0..G-1, k slot G, v slot G + 1), read in place on the card;
    returns q' [B, 1, Hkv * G, D]."""
    stage_step = _stage_step(stage_key, stage_step)
    if qkv.dim() != 5 or qkv.shape[1] != 1 or qkv.shape[3] < 3:
        raise ValueError(f"rope_stage_fused takes [B, 1, Hkv, G + 2, D], got "
                         f"{tuple(qkv.shape)}")
    qs, ks = _fused_slots(qkv)
    vs = qkv[..., -1:, :]
    if not _on_card(qkv):
        B, _, Hkv, G2, D = qkv.shape
        return rope_stage_reference(
            qs.reshape(B, 1, Hkv * (G2 - 2), D), ks[..., 0, :],
            vs[..., 0, :], cos, sin, positions, stage_key, stage_value,
            stage_step)
    return _stage_launch(qs, ks, vs, cos, sin, positions, stage_key,
                         stage_value, stage_step)


apply_rope.fwd_launches = 0
apply_rope.bwd_launches = 0
apply_rope.stage_launches = 0

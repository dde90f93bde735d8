"""RMSNorm: the CUDA kernel (K6) and its plain PyTorch version (f32
statistics regardless of activation dtype); and the residual add fused
in front of it (K10, :func:`add_rms_norm`).

:func:`rms_norm` is a ``torch.autograd.Function`` whose forward saves the
row statistic ``rstd`` [rows] f32 and whose backward is written out from
the formulas (:func:`rms_norm_backward_reference`), not replayed op by op.
It dispatches on where x lives:

- CUDA tensors launch ``ops/csrc/rms_norm.cu``, built at first use by
  ``ops/_build.py``, or raise: x and the weight bf16 or f32, contiguous,
  16-byte aligned, the width a multiple of 8 up to
  :data:`MAX_WIDTH`. One launch a forward (a block a row), two a backward
  (dx and per-block dw partials, then their fixed-order sum), on the
  current stream, capture-safe and deterministic. Up to :data:`ROWS_MAX`
  rows (the serving forward's decode steps and smaller prefills) the
  forward is the rows kernel (``rmsnorm_fwd_rows``: a thread a 16-byte
  chunk, the weight loaded with x), whose launch is a shorter chain of
  latencies.
- CPU tensors take the plain pair (:func:`rms_norm_reference`,
  :func:`rms_norm_backward_reference`), which is also what the card holds
  the kernel against.

Each forward launch adds one to ``rms_norm.fwd_launches`` (and, through
the rows kernel, to ``rms_norm.rows_launches``), each backward launch to
``rms_norm.bwd_launches``.

:func:`add_rms_norm` (K10) returns ``r = x + h``, rounded to the dtype as
the eager add rounds it, and ``rms_norm(r)``, from one read of x and h;
it saves r, the weight and rstd. Its backward takes the residual's
incoming gradient ``dr`` beside the norm's ``dy`` and writes ``dr +
rms_norm's dx`` in the same pass (the accumulation autograd would run as
a separate ``add_``); x and h get that one gradient. Same kernel source,
same rules and dispatch (``add_rmsnorm_fwd_rows`` up to :data:`ROWS_MAX`
rows); its counters are ``add_rms_norm.fwd_launches`` (every forward),
``add_rms_norm.rows_launches`` (those through the rows kernel) and
``add_rms_norm.bwd_launches``.

K10's combine mode (:func:`add_rms_norm_combine`,
``add_rmsnorm_fwd_rows_combine``) takes a MoE layer's expert outputs and
its routing's two choices and weights in h's place: the rows kernel with
the MoE combine's weighted two-row sum (``ops/moe.py``'s K14) in front of
the add, bitwise K14 then K10, one launch, counted in
``add_rms_norm.combine_launches`` as well as in the two forward counters.
It takes CUDA tensors only: its wrapper, which also gives CPU tensors
their plain versions, is ``ops/moe.py::combine_add_rms_norm``. It has no
backward (the MoE kernels have none yet): an input that requires grad
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

_SOURCE = "rms_norm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The widest row the kernel takes (8 elements x 256 threads x 4 chunks).
MAX_WIDTH = 8192
#: The most rows a forward takes the rows kernel for (a thread a chunk):
#: a decode step's slots, the extend's chunks, a prefill up to 1024
#: tokens. Measured on an H100 (``tools/fused_ab.py --sweep``), it is the
#: faster of the two up to 1024 rows of 2048 and 4096, and K6's is not
#: from 2048 rows on; above it, a block of 256 threads a row.
ROWS_MAX = 1024


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, *,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd): RMSNorm over the last dim in plain PyTorch; rstd = 1 /
    sqrt(mean(x^2) + eps) [...] f32, y = (x rstd) weight in f32, cast once
    to x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (xf * rstd * weight.float()).to(x.dtype)
    return y, rstd[..., 0]


def rms_norm_backward_reference(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
    rstd: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dweight) of :func:`rms_norm_reference`, from the formulas: with
    n = x rstd and g = dy weight (f32), dx = rstd (g - n mean(g n)) in x's
    dtype, dweight = sum over rows of dy n in weight's dtype."""
    r = rstd[..., None]
    n = x.float() * r
    dyf = dy.float()
    g = dyf * weight.float()
    dot = torch.mean(g * n, dim=-1, keepdim=True)
    dx = (r * (g - n * dot)).to(x.dtype)
    dw = (dyf * n).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype)
    return dx, dw


def add_rms_norm_reference(
    x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, *,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r, y, rstd): r = x + h in x's dtype (one rounding, as the eager add),
    then :func:`rms_norm_reference` of r."""
    r = x + h
    y, rstd = rms_norm_reference(r, weight, eps=eps)
    return r, y, rstd


def add_rms_norm_backward_reference(
    r: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
    rstd: torch.Tensor, dr: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dweight) of :func:`add_rms_norm_reference`: the norm's dx of r,
    in r's dtype, plus the residual's incoming gradient ``dr`` (None: none),
    rounded again; dx is the gradient of both x and h."""
    dx, dw = rms_norm_backward_reference(r, weight, dy, rstd)
    return (dx if dr is None else dr + dx), dw


def _entry(lib: ctypes.CDLL, name: str, pointers: int, tail: list):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * pointers + tail
    return fn


_FWD_TAIL = [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_BWD_TAIL = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def bind(lib: ctypes.CDLL):
    """K6's C entry points (forward, backward, the rows forward) with their
    signatures."""
    return (_entry(lib, "kftpu_rms_norm_fwd", 4, _FWD_TAIL),
            _entry(lib, "kftpu_rms_norm_bwd", 7, _BWD_TAIL),
            _entry(lib, "kftpu_rms_norm_fwd_rows", 4, _FWD_TAIL))


def bind_add(lib: ctypes.CDLL):
    """K10's C entry points (forward, backward, the rows forward) with
    their signatures."""
    return (_entry(lib, "kftpu_add_rms_norm_fwd", 6, _FWD_TAIL),
            _entry(lib, "kftpu_add_rms_norm_bwd", 8, _BWD_TAIL),
            _entry(lib, "kftpu_add_rms_norm_fwd_rows", 6, _FWD_TAIL))


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind(load_library(_SOURCE))


@functools.lru_cache(maxsize=None)
def _add_kernel_fns():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind_add(load_library(_SOURCE))


def bind_combine(lib: ctypes.CDLL):
    """K10's combine-mode C entry with its signature."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.kftpu_add_rms_norm_fwd_combine
    fn.restype = i
    fn.argtypes = [i, i] + [p] * 6 + [ctypes.c_longlong] + [p] * 4 + _FWD_TAIL
    return fn


@functools.lru_cache(maxsize=None)
def _combine_kernel_fn():
    from kubeflow_tpu_torch.ops._build import load_library

    return bind_combine(load_library(_SOURCE))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"rms_norm runs on cuda (kernel) or cpu (plain "
                     f"version), not {x.device}")


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    E = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise ValueError(f"rms_norm kernel takes bf16 or f32 x and weight, "
                         f"got {x.dtype} and {weight.dtype}")
    if weight.device != x.device or weight.shape != (E,):
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} "
                         f"does not match x [..., {E}] on {x.device}")
    if E % 8 or E > MAX_WIDTH or x.numel() == 0:
        raise ValueError(f"rms_norm kernel takes a width that is a multiple "
                         f"of 8 up to {MAX_WIDTH} and a non-empty x, got "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("weight", weight)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rms_norm kernel takes a contiguous, 16-byte "
                             f"aligned {name}")


def _by_rows(rows: int, by_rows: Optional[bool]) -> bool:
    return rows <= ROWS_MAX if by_rows is None else by_rows


def _fwd_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float,
                by_rows: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward launch; ``by_rows``: the rows kernel (None: up to
    ROWS_MAX rows)."""
    _check(x, weight)
    E = x.shape[-1]
    rows = x.numel() // E
    by_rows = _by_rows(rows, by_rows)
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[2 if by_rows else 0](
            _DTYPES[x.dtype], _DTYPES[weight.dtype], x.data_ptr(),
            weight.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows, E,
            float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm forward launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)} {x.dtype})")
    rms_norm.fwd_launches += 1
    rms_norm.rows_launches += by_rows
    return y, rstd


def _bwd_kernel(x, weight, dy, rstd) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    E = x.shape[-1]
    rows = x.numel() // E
    blocks = min(rows, 4 * _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    partial = torch.empty((blocks, E), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel_fns()[1](_DTYPES[x.dtype], _DTYPES[weight.dtype],
                              x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                              rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                              partial.data_ptr(), rows, E, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm backward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    rms_norm.bwd_launches += 1
    return dx, dw


def _add_fwd_kernel(x, h, weight, eps, by_rows: Optional[bool] = None):
    """K10's forward launch; ``by_rows`` as :func:`_fwd_kernel`'s."""
    _check(x, weight)
    if h.shape != x.shape or h.dtype != x.dtype or h.device != x.device \
            or not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError(f"add_rms_norm kernel takes h like x "
                         f"{tuple(x.shape)} {x.dtype}, contiguous and 16-byte "
                         f"aligned; got {tuple(h.shape)} {h.dtype}")
    E = x.shape[-1]
    rows = x.numel() // E
    by_rows = _by_rows(rows, by_rows)
    r, y = torch.empty_like(x), torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _add_kernel_fns()[2 if by_rows else 0](
            _DTYPES[x.dtype], _DTYPES[weight.dtype], x.data_ptr(),
            h.data_ptr(), weight.data_ptr(), r.data_ptr(), y.data_ptr(),
            rstd.data_ptr(), rows, E, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"add_rms_norm forward launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    add_rms_norm.fwd_launches += 1
    add_rms_norm.rows_launches += by_rows
    return r, y, rstd


def add_rms_norm_combine(x: torch.Tensor, ye: torch.Tensor, g1: torch.Tensor,
                         g2: torch.Tensor, dest1: torch.Tensor,
                         dest2: torch.Tensor, weight: torch.Tensor, *,
                         eps: float = 1e-6):
    """K10's combine mode, one launch on CUDA tensors: (r, y, rstd) of
    ``add_rms_norm(x, h, weight)`` where h [rows] = g1 ye[dest1] + g2
    ye[dest2] in f32 rounded to x's dtype, ye [S, E] in x's dtype with row
    S read as 0 (x's rows, flattened, are the routed tokens; g1, g2 f32,
    dest1, dest2 int32 [rows])."""
    if x.device.type != "cuda":
        raise ValueError("K10's combine mode takes CUDA tensors (CPU "
                         "tensors: ops/moe.py::combine_add_rms_norm)")
    _check(x, weight)
    E = x.shape[-1]
    rows = x.numel() // E
    if ye.dim() != 2 or ye.shape[1] != E or ye.dtype != x.dtype \
            or ye.device != x.device or not ye.is_contiguous() \
            or ye.data_ptr() % 16:
        raise ValueError(f"add_rms_norm's combine takes expert rows [S, "
                         f"{E}] {x.dtype}, contiguous and 16-byte aligned, "
                         f"got {ye.dtype} {tuple(ye.shape)}")
    for name, t, dtype in (("g1", g1, torch.float32),
                           ("g2", g2, torch.float32),
                           ("dest1", dest1, torch.int32),
                           ("dest2", dest2, torch.int32)):
        if t.shape != (rows,) or t.dtype != dtype or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"add_rms_norm's combine takes {name} [{rows}] "
                             f"{dtype}, got {t.dtype} {tuple(t.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, ye, g1, g2)):
        raise NotImplementedError(
            "K10's combine mode has no backward (the MoE kernels have none "
            "yet: the training slice, ROADMAP Queue 1 item 6c)")
    r, y = torch.empty_like(x), torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _combine_kernel_fn()(
            _DTYPES[x.dtype], _DTYPES[weight.dtype], x.data_ptr(),
            ye.data_ptr(), g1.data_ptr(), g2.data_ptr(), dest1.data_ptr(),
            dest2.data_ptr(), ye.shape[0], weight.data_ptr(), r.data_ptr(),
            y.data_ptr(), rstd.data_ptr(), rows, E, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"add_rms_norm combine launch failed: CUDA error "
                           f"{rc} (x {tuple(x.shape)} {x.dtype})")
    add_rms_norm.fwd_launches += 1
    add_rms_norm.rows_launches += 1
    add_rms_norm.combine_launches += 1
    return r, y, rstd


def _add_bwd_kernel(r, weight, dy, rstd, dr):
    _check(r, weight)
    for name, g in (("dy", dy), ("dr", dr)):
        if g is not None and (g.shape != r.shape or g.dtype != r.dtype):
            raise ValueError(f"{name} {tuple(g.shape)} {g.dtype} does not "
                             f"match r {tuple(r.shape)} {r.dtype}")
    dy = dy.contiguous()
    dr = None if dr is None else dr.contiguous()
    E = r.shape[-1]
    rows = r.numel() // E
    blocks = min(rows, 4 * _sm_count(r.device.index or 0))
    dx = torch.empty_like(r)
    dw = torch.empty_like(weight)
    partial = torch.empty((blocks, E), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = _add_kernel_fns()[1](
            _DTYPES[r.dtype], _DTYPES[weight.dtype], r.data_ptr(),
            weight.data_ptr(), dy.data_ptr(),
            0 if dr is None else dr.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), partial.data_ptr(), rows, E,
            blocks, stream)
    if rc != 0:
        raise RuntimeError(f"add_rms_norm backward launch failed: CUDA error "
                           f"{rc} (r {tuple(r.shape)} {r.dtype})")
    add_rms_norm.bwd_launches += 1
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """y of (x, weight); saves x, weight and rstd."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        if _on_card(x):
            y, rstd = _fwd_kernel(x, weight, eps)
        else:
            y, rstd = rms_norm_reference(x, weight, eps=eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        if _on_card(x):
            dx, dw = _bwd_kernel(x, weight, dy, rstd)
        else:
            dx, dw = rms_norm_backward_reference(x, weight, dy, rstd)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim; stats in f32, output in x.dtype."""
    return _RMSNorm.apply(x, weight, eps)


rms_norm.fwd_launches = 0
rms_norm.rows_launches = 0
rms_norm.bwd_launches = 0


class _AddRMSNorm(torch.autograd.Function):
    """(r, y) of (x, h, weight); saves r, weight and rstd."""

    @staticmethod
    def forward(ctx, x, h, weight, eps):
        if _on_card(x):
            r, y, rstd = _add_fwd_kernel(x, h, weight, eps)
        else:
            r, y, rstd = add_rms_norm_reference(x, h, weight, eps=eps)
        ctx.save_for_backward(r, weight, rstd)
        ctx.set_materialize_grads(False)
        return r, y

    @staticmethod
    def backward(ctx, dr, dy):
        if dy is None:                   # y unused: r = x + h alone
            return dr, dr, None, None
        r, weight, rstd = ctx.saved_tensors
        if _on_card(r):
            dx, dw = _add_bwd_kernel(r, weight, dy, rstd, dr)
        else:
            dx, dw = add_rms_norm_backward_reference(r, weight, dy, rstd, dr)
        return dx, dx, dw, None


def add_rms_norm(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor, *,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r, y): the residual r = x + h in x's dtype and y = RMSNorm(r) (stats
    in f32), one kernel launch on the card."""
    return _AddRMSNorm.apply(x, h, weight, eps)


add_rms_norm.fwd_launches = 0
add_rms_norm.rows_launches = 0
add_rms_norm.combine_launches = 0
add_rms_norm.bwd_launches = 0

"""A/B device timing of builds of one kernel on one NVIDIA GPU: the
flash-attention backward (K2, the default), the decode attention (K3),
the int8-weight product (K4), the int8 expert product (K15) or the MoE
routing and combine (K12, K14 and K10's combine mode):
``python3 kernel_ab.py DIR [DIR ...] [--kernel bwd|decode|int8|experts|moe]
[--shapes ...] [--variants ...]``.

Each DIR is the root of a checkout, or of a copy of its
``kubeflow_tpu_torch/ops/csrc`` (for instance ``git archive <rev>
kubeflow_tpu_torch/ops/csrc | tar -x -C DIR``, into a directory that
``.gitignore`` lists); ``.`` is this checkout. Every build's
``flash_attention_bwd.cu`` is compiled with the flags of ``ops/_build.py``
(nvcc calls started together; each build's ptxas register, spill and
wgmma-serialisation lines are printed), loaded through the C entry the
port calls, run on the same inputs and held against
``flash_attention_backward_reference`` (each grad within 2e-2 x max|plain|,
two calls bitwise equal). Then the builds are timed in CUDA-graph replays,
taking turns (forward order, then reverse; six rounds: the median and the
least per build), and each build's kernels are timed apart by name under
torch.profiler. Shapes (B, S, H/Hkv, D, all causal): ``train`` 12, 2048,
16/8, 128 (the 700M model's); ``s512`` 8, 512, 16/8, 128; ``d64`` 8, 512,
16/8, 64. Exits 2 without CUDA and 1 when a build disagrees.

``--kernel decode`` does the same for ``decode_attention.cu``: each build
is held against ``decode_attention_reference`` (within 2e-2 x max|plain|,
two calls bitwise equal) over the bf16 and the int8 cache, staged (8
staging rows, all live), and timed in turns warm (every call on one set of
rows, which the 50 MB L2 keeps from the second call on) and cold (calls
rotating over enough cache sets that the live rows of all of them exceed
twice the L2). A build whose source still holds the earlier split and
merge kernels is called through their C interface (its f32 partials
allocated here). Shapes (B, H/Hkv, D, L, live rows): ``served`` 8, 32/8, 128, 1024,
the serve burst's 36-516; ``long`` 8, 32/8, 128, 8192, 1024-8192; ``even``
and ``one`` the served rows spread evenly, or one slot's 516 alone.
``paged`` (B 48, L 512, live rows 128-255, 32 staging rows, the paged
serve phase's decode shape) runs each build that has the block-table
entry three ways, cold, in turns: over a pool of 16-row pages through a
shuffled table, dense over the same rows gathered (bitwise equal), and
through a table in page order (the dense cache's addresses: what the
lookup itself costs).

``--kernel int8`` does the same for ``int8_linear.cu``: each build is held
against ``int8_linear_reference`` (within 1e-2 x max|plain|, two calls
bitwise equal) and timed in turns warm (one weight set) and cold (calls
rotating over weight sets larger than twice the L2), beside the bound
max(bytes / 3.35 TB/s, 2 M N K / 989 TFLOP/s). Shapes: llama3-8b's decode
products at M = 8 (``q``, ``kv``, ``o``, ``gate``, ``down``, ``lm_head``,
and the grouped launches ``qkv`` and ``gateup``: the default; then each
build's time over a decode step's products is printed, with q/k/v and
gate/up apart and grouped) and the gate shape at prefill token counts
(``m64``, ``m512``, ``m1024``, ``m4096``). A build without the grouped
entry (``kftpu_int8_linear_group``) runs a group as one launch a product,
as it served them. The ``step`` shape serves: one llama3-8b
engine with int8 weights (random, seeded; staged bf16 cache, 8 slots) per
build, each capturing its CUDA graphs with that build's K4, and one with
the same weights in bf16 (cuBLAS products) as the yardstick, then
full-batch decode chunks (8 steps) timed in turns on the host clock, each
ending in the tokens' fetch: the decode step as the server runs it,
launch gaps and all.

``--kernel experts`` does the same for ``int8_experts.cu`` at
``chip_smoke.py``'s K15 cases (E = 8; rows an expert, N, K): ``decode_gate``
4, 14336, 4096; ``decode_down`` 4, 4096, 14336; ``prefill_gate`` 1280,
14336, 4096; ``prefill_down`` 1280, 4096, 14336; ``odd_gate`` 37, 14336,
4096; ``extend_gate`` 128, 14336, 4096. Each build is held against
``int8_experts_reference`` (within 1e-2 x max|plain|, two calls bitwise
equal) and timed in CUDA-graph replays in turns (a product's weights,
470-587 MB, exceed the L2 ten times: every call reads them from device
memory), beside the bound and ``torch.bmm`` on experts dequantized
beforehand. ``--variants`` times the tiled kernel's launch plans apart
(rows an expert > 16), where the build's source has
``kftpu_int8_experts_config``: ``bm64``/``bm128``/``bm256`` tokens a
tile, ``o1``/``o2`` the grid's order (token tiles or experts fastest),
combined as in ``bm256o1``. The ``fused_decode``, ``fused_r1``,
``fused_r13`` and ``fused_r16`` shapes (``chip_smoke.py``'s
K15_FUSED_CASES: gate/up at 4, 1, 13 and 16 rows an expert, the rows
gathered from 8, 8, 32 and 32 tokens) also build each DIR's ``moe.cu``
and ``swiglu.cu`` and time, in turns, every build's chain of four
launches (K13's gather, K15's gate and up products, K9) against the
fused gate/up launch where the build has ``kftpu_int8_experts_swiglu``:
all bitwise equal, and within 1e-2 x max|plain| of
``int8_experts_swiglu_reference``.

``--kernel moe`` builds each DIR's ``moe.cu`` and ``rms_norm.cu`` and
times, in turns, K12 at ``chip_smoke.py``'s MOE_CASES (``decode``: T 8,
capacity 4; ``prefill``: T 4096, capacity 1280; E 8, bf16 logits with a
hot expert), each build held bitwise against ``route_reference`` (a
build whose source still takes the gates and positions scratch is called
with it), and the MoE combine
in front of the residual add + RMSNorm at ``c8``, ``c48``, ``c1024``
rows of 4096 (cold over sets past twice the L2): K14 then K10's rows
kernel of every build, and K10's combine mode where the build has it,
bitwise the pair. ``--variants nb1,nb2,nb4,nb8`` also builds copies of
each DIR's ``moe.cu`` whose group form takes that many blocks a group
whatever g (``MOE_PLAN`` replaced; a source without that line is
skipped), timed at ``prefill`` under ``DIR:nb<n>``: the A/B of one
1024-thread block against a cluster, kept out of the program.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from chip_smoke import (
    K15_CASES,
    K15_E,
    K15_FUSED_CASES,
    bytes_ms,
    int8_experts_bound_ms,
)
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import decode_attention as da
from kubeflow_tpu_torch.ops import flash_attention as fa

SHAPES = {             # B, S, H, Hkv, D
    "train": (12, 2048, 16, 8, 128),
    "s512": (8, 512, 16, 8, 128),
    "d64": (8, 512, 16, 8, 64),
}
TOL = 2e-2             # the bf16 bound of chip_smoke.py and the card tests
CSRC = os.path.join("kubeflow_tpu_torch", "ops", "csrc")
# kernel -> (source, the kernels' name stem, the entries ptxas reports on)
KERNELS = {"bwd": ("flash_attention_bwd.cu", "flash_bwd", "bf16"),
           "decode": ("decode_attention.cu", "decode_attn", "decode_attn"),
           "int8": ("int8_linear.cu", "int8_linear", "int8_linear"),
           "experts": ("int8_experts.cu", "int8_experts", "int8_experts"),
           "moe": ("moe.cu", "moe_", "moe_")}


def kernel_name(name: str, stem: str = "flash_bwd") -> str:
    """``stem...`` and its template arguments, from a mangled or a
    demangled kernel name."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[max(name.find(stem), 0):]
    return name.split("EEEEE")[0].split("(")[0].split("'")[0]


#: kernel -> the other sources of each DIR it builds, into side_lib(lib,
#: source): K10 beside K12 and K14; K13 and K9 beside K15 (the chain that
#: its fused gate/up launch replaces).
SIDE_SOURCES = {"moe": ("rms_norm.cu",), "experts": ("moe.cu", "swiglu.cu")}


def side_lib(lib: str, source: str) -> str:
    return f"{lib[:-3]}_{os.path.splitext(source)[0]}.so"


def build(root: str, lib: str, kernel: str = "bwd",
          path: str | None = None) -> list:
    """Compile ``root``'s source of ``kernel`` (or ``path``, a variant of
    it whose includes resolve in ``root``) into ``lib``, and its
    SIDE_SOURCES beside it; returns ptxas's report lines for the kernels
    it times."""
    source, stem, keep = KERNELS[kernel]
    for side in SIDE_SOURCES.get(kernel, ()):
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
             side_lib(lib, side), os.path.join(root, CSRC, side)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}:\n{proc.stderr}")
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
         os.path.join(root, CSRC), "-o", lib,
         path or os.path.join(root, CSRC, source)], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {root}:\n{proc.stderr}")
    report, bf16 = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            bf16 = keep in line
            if bf16:
                report.append("  " + kernel_name(line.split("'")[1], stem))
        elif bf16 and ("registers" in line or "spill" in line):
            report.append("    " + line.split(":", 1)[-1].strip())
        elif "C75" in line:     # e.g. C7512: wgmma serialised for lack of registers
            report.append(f"    {line.split(')')[0].split('(')[-1]} in "
                          f"{kernel_name(line.split(chr(39))[1])}")
    return report


def turns(graphs: dict, per_replay: int, rounds: int = 6) -> dict:
    """Device ms per call of each label's graph (``per_replay`` calls a
    replay), timed in turns: forward order, then reverse, ``rounds``
    times; each turn times two replays after one untimed."""
    times = {label: [] for label in graphs}
    order = list(graphs)
    for rnd in range(rounds):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            graphs[label].replay()
            start.record()
            graphs[label].replay()
            graphs[label].replay()
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / (2 * per_replay))
    return times


def capture(fn, calls: int):
    """``calls`` calls of ``fn`` in one CUDA graph, warmed up on the side
    stream that captures them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    return graph


def run_shape(name: str, fns: dict) -> bool:
    b, s, h, hkv, d = SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, do = rand(b, s, h, d), rand(b, s, hkv, d), rand(b, s, hkv, d), \
        rand(b, s, h, d)
    with torch.no_grad():
        o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    delta = fa._delta(o, do, None)
    off = fa._offset_tensor(0, q.device)

    def call(fn):
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        strides = (ctypes.c_longlong * 21)(*(
            st for t in (q, k, v, do, dq, dk, dv) for st in t.stride()[:3]))
        rc = fn(1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), off.data_ptr(), b, h, hkv, s, s,
                ctypes.addressof(strides), d ** -0.5, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return dq, dk, dv

    want = fa.flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=True, scale=d ** -0.5)
    ok = True
    for label, fn in fns.items():
        got = call(fn)
        errs = [((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item() for g, w in zip(got, want)]
        same = all(torch.equal(a, c) for a, c in zip(got, call(fn)))
        good = max(errs) <= TOL and same
        ok &= good
        print(f"{name} {label}: max err / max|plain| dq {errs[0]:.3e} dk "
              f"{errs[1]:.3e} dv {errs[2]:.3e}; two calls bitwise equal: "
              f"{same}{'' if good else '  FAIL'}", flush=True)
    del want

    graphs = {label: capture(lambda fn=fn: call(fn), 10)
              for label, fn in fns.items()}
    times = turns(graphs, 10)
    print(f"{name} device ms per call (median / least of 6 turns): " + "; ".join(
        f"{label} {statistics.median(t):.4f} / {min(t):.4f}"
        for label, t in times.items()), flush=True)
    del graphs
    for label, fn in fns.items():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call(fn)
            torch.cuda.synchronize()
        parts = [f"{kernel_name(e.key)} {e.device_time_total / e.count / 1e3:.4f}"
                 for e in prof.key_averages() if "flash_bwd" in e.key]
        print(f"  {name} {label} by kernel (ms): " + "; ".join(parts),
              flush=True)
    return ok


# name -> (L, the slots' live rows); B = 8, H/Hkv = 32/8, D = 128, staged.
# "even" spreads the served rows evenly over the slots and "one" gives all
# of the longest slot's rows to one slot: they tell load imbalance across
# the card from the latency of one slot's blocks.
DECODE_SHAPES = {
    "served": (1024, [36, 46, 116, 136, 216, 266, 416, 516]),
    "long": (8192, [1024, 2048, 3072, 4096, 5120, 6144, 7168, 8192]),
    "even": (1024, [218] * 7 + [222]),
    "one": (1024, [516] + [0] * 7),
}
DECODE_H, DECODE_HKV, DECODE_D, DECODE_C = 32, 8, 128, 8
L2_BYTES = 50e6
PEAK_BYTES_PER_S = 3.35e12


def decode_caller(root: str, lib: str):
    """The build's C entry as ``call(q, k, v, idx, ks, vs, sk, sv,
    stage_rows) -> o``: this checkout's interface, or the earlier one
    (split and merge kernels, f32 partials passed in) where the source
    holds it."""
    with open(os.path.join(root, CSRC, KERNELS["decode"][0])) as f:
        split_merge = "decode_attn_merge" in f.read()
    fn = getattr(ctypes.CDLL(lib), "kftpu_decode_attention")
    fn.restype = ctypes.c_int
    if split_merge:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    else:
        fn, plan = da.bind(ctypes.CDLL(lib))
    try:
        paged_fn = da.bind_paged(ctypes.CDLL(lib))
    except AttributeError:          # a build before the block-table entry
        paged_fn = None

    def call(q, k, v, idx, ks, vs, sk, sv, stage_rows):
        b, _, h, d = q.shape
        _, L, hkv, _ = k.shape
        o = torch.empty_like(q)
        scale_strides = ks.stride()[:3] if ks is not None else (0, 0, 0)
        strides = (ctypes.c_longlong * 11)(
            q.stride(0), q.stride(2), *k.stride()[:3], *scale_strides,
            *sk.stride()[:3])
        head = (d, h // hkv, int(ks is not None), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), ks.data_ptr() if ks is not None else None,
                vs.data_ptr() if vs is not None else None, idx.data_ptr(),
                sk.data_ptr(), sv.data_ptr(), stage_rows)
        tail = (ctypes.addressof(strides), d ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        if split_merge:         # its plan: 64-row splits, at most 64
            splits = min(-(-L // 64), 64)
            total = splits + (1 if stage_rows else 0)
            part_acc = torch.empty(b, h, total, d, device=q.device)
            part_ml = torch.empty(b, h, total, 2, device=q.device)
            rc = fn(*head, o.data_ptr(), part_acc.data_ptr(),
                    part_ml.data_ptr(), b, hkv, L, splits, -(-L // splits),
                    *tail)
        else:
            rc = fn(*head, sk.shape[1], o.data_ptr(), b, hkv, L,
                    da.split_plan(L), *tail)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return o

    def paged(q, k, v, idx, ks, vs, sk, sv, stage_rows, tables, bs):
        """The block-table entry over a pool [P + 1, bs, Hkv, D]."""
        b, _, h, d = q.shape
        hkv = k.shape[2]
        L = tables.shape[1] * bs
        o = torch.empty_like(q)
        scale_strides = ks.stride()[:3] if ks is not None else (0, 0, 0)
        strides = (ctypes.c_longlong * 11)(
            q.stride(0), q.stride(2), *k.stride()[:3], *scale_strides,
            *sk.stride()[:3])
        rc = paged_fn(d, h // hkv, int(ks is not None), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(),
                      ks.data_ptr() if ks is not None else None,
                      vs.data_ptr() if vs is not None else None,
                      idx.data_ptr(), tables.data_ptr(), tables.shape[1], bs,
                      k.shape[0], sk.data_ptr(), sv.data_ptr(), stage_rows,
                      sk.shape[1], o.data_ptr(), b, hkv, da.split_plan(L),
                      ctypes.addressof(strides), d ** -0.5,
                      torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"paged launch failed: CUDA error {rc}")
        return o

    def cluster(d, g, int8, b, hkv, L):
        """The blocks a (slot, kv head) is split over."""
        if split_merge:
            return f"{min(-(-L // 64), 64)} splits + merge"
        return plan(d, g, int8, b, hkv, da.split_plan(L))

    call.cluster = cluster
    call.paged = paged if paged_fn is not None else None
    return call


def run_decode(name: str, calls: dict) -> bool:
    """Every build at one decode shape, bf16 then int8 cache, staged."""
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference

    L, lengths = DECODE_SHAPES[name]
    b, h, hkv, d = len(lengths), DECODE_H, DECODE_HKV, DECODE_D
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q = rand(b, 1, h, d)
    sk, sv = rand(b, DECODE_C, hkv, d), rand(b, DECODE_C, hkv, d)
    idx = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    rows = sum(lengths)
    ok = True
    for cache in ("bf16", "int8"):
        row_bytes = hkv * d * 2 * (2 if cache == "bf16" else 1) \
            + (hkv * 8 if cache == "int8" else 0)
        n_sets = max(2, -(-int(2 * L2_BYTES) // (rows * row_bytes)))
        sets = []
        for _ in range(n_sets):
            k, v = rand(b, L, hkv, d), rand(b, L, hkv, d)
            if cache == "int8":
                (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            else:
                ks = vs = None
            sets.append((k, v, ks, vs))
        k, v, ks, vs = sets[0]
        scales = {} if ks is None else {"k_scale": ks, "v_scale": vs}
        want = decode_attention_reference(
            q, k, v, idx, **scales, stage_key=sk, stage_value=sv,
            stage_step=DECODE_C - 1).float()
        for label, call in calls.items():
            got = call(q, k, v, idx, ks, vs, sk, sv, DECODE_C)
            err = ((got.float() - want).abs().max()
                   / want.abs().max()).item()
            same = torch.equal(got, call(q, k, v, idx, ks, vs, sk, sv,
                                         DECODE_C))
            good = err <= TOL and same
            ok &= good
            print(f"{name} {cache} {label}: blocks a (slot, kv head) "
                  f"{call.cluster(d, h // hkv, cache == 'int8', b, hkv, L)}; "
                  f"max err / max|plain| {err:.3e}; "
                  f"two calls bitwise equal: {same}"
                  f"{'' if good else '  FAIL'}", flush=True)
        nbytes = rows * row_bytes + b * hkv * DECODE_C * d * 4 + 4 * b * h * d
        for mode, order in (("warm", [0] * 10),
                            ("cold", list(range(n_sets)) * max(
                                1, -(-10 // n_sets)))):
            def rotating(call, order=order):
                sets_in_turn = itertools.cycle(order)

                def run():
                    k, v, ks, vs = sets[next(sets_in_turn)]
                    return call(q, k, v, idx, ks, vs, sk, sv, DECODE_C)
                return run

            graphs = {label: capture(rotating(c), len(order))
                      for label, c in calls.items()}
            times = turns(graphs, len(order))
            print(f"{name} {cache} staged {mode} ({n_sets if mode == 'cold' else 1}"
                  f" cache sets) device ms per call (median / least of 6 "
                  f"turns): " + "; ".join(
                      f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
                      for label, t in times.items())
                  + f"; bound {1e3 * nbytes / PEAK_BYTES_PER_S:.5f} (bytes)",
                  flush=True)
            del graphs
        for label, call in calls.items():
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call(q, k, v, idx, ks, vs, sk, sv, DECODE_C)
                torch.cuda.synchronize()
            parts = [f"{kernel_name(e.key, 'decode_attn')} x{e.count // 5} "
                     f"{e.device_time_total / e.count / 1e3:.5f}"
                     for e in prof.key_averages() if "decode_attn" in e.key]
            print(f"  {name} {cache} {label} by kernel, warm (ms): "
                  + "; ".join(parts), flush=True)
        del sets, k, v, ks, vs
        torch.cuda.empty_cache()
    return ok


# name -> (M, the products' N, K, scale period, launches in a decode step
# with q/k/v and gate/up apart, launches with them grouped); M = 8 is the
# decode step's (one row a slot). A shape of several N is one grouped
# launch (kftpu_int8_linear_group) of products that read the same x.
INT8_SHAPES = {
    "q": (8, (4096,), 4096, 1, 32, 0), "kv": (8, (1024,), 4096, 1, 64, 0),
    "o": (8, (4096,), 4096, 128, 32, 32),
    "gate": (8, (14336,), 4096, 1, 64, 0),
    "down": (8, (4096,), 14336, 1, 32, 32),
    "lm_head": (8, (128256,), 4096, 1, 1, 1),
    "qkv": (8, (4096, 1024, 1024), 4096, 1, 0, 32),
    "gateup": (8, (14336, 14336), 4096, 1, 0, 32),
    "m64": (64, (14336,), 4096, 1, 0, 0),
    "m512": (512, (14336,), 4096, 1, 0, 0),
    "m1024": (1024, (14336,), 4096, 1, 0, 0),
    "m4096": (4096, (14336,), 4096, 1, 0, 0),
}


def group_adapter(entry):
    """A stand-in for ``kftpu_int8_linear_group`` in a build that lacks it:
    the same arguments, one ``kftpu_int8_linear`` launch per product (what
    such a build ran for q/k/v and gate/up)."""
    def arr(addr, t):
        return ctypes.cast(addr, ctypes.POINTER(t))

    def group(x, m, k, ldx, n, qs, scales, ys, ns, ss, splits, stream):
        q, sc, y = (arr(a, ctypes.c_void_p) for a in (qs, scales, ys))
        nn, per = arr(ns, ctypes.c_int), arr(ss, ctypes.c_int)
        for i in range(n):
            rc = entry(x, q[i], sc[i], y[i], m, nn[i], k, per[i], ldx, splits,
                       stream)
            if rc != 0:
                return rc
        return 0
    return group


def int8_caller(lib: str):
    """The build's C entries as ``call(x, [(q, scale), ...]) -> [y, ...]``
    (one product through ``kftpu_int8_linear``, several through the grouped
    entry, or one launch each where the build has none); its last int
    argument 0 leaves every build's own plan in force. ``call.group`` is
    the grouped entry (or its stand-in), as ``int8_linear._kernel_fns``
    gives it."""
    so = ctypes.CDLL(lib)
    fn = so.kftpu_int8_linear
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    try:
        group = so.kftpu_int8_linear_group
        group.restype = ctypes.c_int
        group.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int]
                          + [ctypes.c_void_p] * 5
                          + [ctypes.c_int, ctypes.c_void_p])
    except AttributeError:
        group = group_adapter(fn)

    def call(x, pairs):
        m, k = x.shape
        ys = [torch.empty(m, q.shape[0], dtype=torch.bfloat16, device=x.device)
              for q, _ in pairs]
        stream = torch.cuda.current_stream().cuda_stream
        if len(pairs) == 1:
            (q, scale), = pairs
            rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                    ys[0].data_ptr(), m, q.shape[0], k, scale.shape[1],
                    x.stride(0), 0, stream)
        else:
            n = len(pairs)
            arrays = [(ctypes.c_void_p * n)(*v) for v in (
                [q.data_ptr() for q, _ in pairs],
                [sc.data_ptr() for _, sc in pairs],
                [y.data_ptr() for y in ys])]
            arrays += [(ctypes.c_int * n)(*v) for v in (
                [q.shape[0] for q, _ in pairs],
                [sc.shape[1] for _, sc in pairs])]
            rc = group(x.data_ptr(), m, k, x.stride(0), n,
                       *(ctypes.addressof(a) for a in arrays), 0, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return ys

    call.group = group
    return call


def run_int8(name: str, calls: dict, step: dict) -> bool:
    """Every build at one product shape (a group: one launch); adds each
    build's cold and warm ms times the shape's launches in a decode step
    to ``step``, with q/k/v and gate/up apart and grouped."""
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.serving.engine import _quantize_leaf

    m, ns, k, period, apart, grouped = INT8_SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(4)
    n_sets = max(2, -(-int(2 * L2_BYTES) // (sum(ns) * k)))
    sets = []
    for _ in range(n_sets):
        pairs = []
        for n in ns:
            w = torch.randn(n, k, generator=gen, device="cuda") * 0.02
            pairs.append(_quantize_leaf(w, period))
            del w
        sets.append(pairs)
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    want = [il.int8_linear_reference(x, q, sc).float() for q, sc in sets[0]]
    ok = True
    for label, call in calls.items():
        got = call(x, sets[0])
        err = max(((g.float() - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, call(x, sets[0])))
        good = err <= 1e-2 and same
        ok &= good
        print(f"{name} {label}: max err / max|plain| {err:.3e}; two calls "
              f"bitwise equal: {same}{'' if good else '  FAIL'}", flush=True)
    nbytes = sum(n * k + 2 * n * period + 2 * m * n for n in ns) + 2 * m * k
    bound = 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                      2.0 * m * sum(ns) * k / 989e12)
    calls_per = 10 if m <= 16 else 2
    for mode, order in (("warm", [0] * calls_per),
                        ("cold", list(range(n_sets)) * max(
                            1, -(-calls_per // n_sets)))):
        def rotating(call, order=order):
            sets_in_turn = itertools.cycle(order)
            return lambda: call(x, sets[next(sets_in_turn)])

        graphs = {label: capture(rotating(c), len(order))
                  for label, c in calls.items()}
        times = turns(graphs, len(order))
        print(f"{name} (M {m}, N {'+'.join(map(str, ns))}, K {k}, S {period}) "
              f"{mode} ({n_sets if mode == 'cold' else 1} weight sets) device "
              f"ms per call (median / least of 6 turns): " + "; ".join(
                  f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
                  for label, t in times.items())
              + f"; bound {bound:.5f}", flush=True)
        for label, t in times.items():
            for kind, count in (("apart", apart), ("grouped", grouped)):
                if count:
                    key = (label, mode, kind)
                    step[key] = (step.get(key, 0.0)
                                 + count * statistics.median(t))
        del graphs
    del sets, x, want
    torch.cuda.empty_cache()
    return ok


def run_int8_step(calls: dict, chunks: int = 8) -> bool:
    """Each build's K4 in a llama3-8b int8-weight engine, and the bf16
    engine: ms a decode step, median and least of ``chunks`` chunks an
    engine, taken in turns."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    engines = {}
    real = il._kernel_fns
    try:
        for label, call in [*calls.items(), ("bf16 (cuBLAS)", None)]:
            # The engine launches K4 through _kernel_fns()'s grouped entry
            # (a single product is a group of one); the graphs it captures
            # keep this build's kernel.
            il._kernel_fns = lambda call=call: (None, call.group)
            with torch.device("cuda"):
                model, _ = get_model("llama3-8b", param_dtype="bfloat16",
                                     decode_staging=8)
            model.init_weights(torch.Generator(device="cuda").manual_seed(0))
            eng = ServingEngine(
                model, ServingConfig(max_batch=8, max_len=1024,
                                     decode_chunk=8,
                                     quantize="int8" if call else ""),
                device="cuda", registry=MetricsRegistry())
            rs = __import__("numpy").random.RandomState(0)
            for _ in range(8):
                eng.submit(rs.randint(0, 128256, 100).tolist(),
                           max_new_tokens=8 * (chunks + 3))
            eng.step()              # admission, prefill, the first chunk
            eng.step()              # the decode graph is captured
            engines[label] = eng
            torch.cuda.synchronize()
    finally:
        il._kernel_fns = real
    times = {label: [] for label in engines}
    order = list(engines)
    for rnd in range(chunks):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            start = time.perf_counter()
            engines[label].step()   # one chunk, ends in the host fetch
            times[label].append((time.perf_counter() - start) * 1e3 / 8)
    print("step: ms a decode step (8 slots, chunks of 8, in turns; median "
          "/ least): " + "; ".join(
              f"{label} {statistics.median(t):.3f} / {min(t):.3f}"
              for label, t in times.items()), flush=True)
    return True


# The paged serve phase's decode shape: 48 slots, max_len 512 in 16-row
# pages, live rows 128-255 (128-token prompts 0-127 tokens into decoding),
# 32 staging rows.
PAGED_B, PAGED_L, PAGED_BS, PAGED_C = 48, 512, 16, 32
PAGED_LENGTHS = [128 + (37 * i) % 128 for i in range(PAGED_B)]


COMBINE_SHAPES = {"c8": 8, "c48": 48, "c1024": 1024}
#: K12's group-form plan in moe.cu: the blocks a group by g.
MOE_PLAN = ("  while (nb < kMaxCluster && nb * 512 < g && 2 * nb <= P / 32) "
            "nb *= 2;")


def moe_variant(root: str, out_dir: str, v: str, index: int):
    """A copy of ``root``'s moe.cu in ``out_dir`` whose group form takes
    ``v`` = ``nb<n>`` blocks a group whatever g, or None where its source
    has no MOE_PLAN line."""
    if not v.startswith("nb") or int(v[2:]) not in (1, 2, 4, 8):
        raise ValueError(f"unknown moe variant {v!r} (nb1, nb2, nb4, nb8)")
    with open(os.path.join(root, CSRC, "moe.cu")) as f:
        src = f.read()
    if MOE_PLAN not in src:
        return None
    path = os.path.join(out_dir, f"moe_variant_{index}.cu")
    with open(path, "w") as f:
        f.write(src.replace(MOE_PLAN, f"  nb = {int(v[2:])};"))
    return path


def moe_callers(root: str, lib: str, label: str) -> dict:
    """The build's K12 as ``{label: route(logits, C) -> Routing}``, and
    unless it is a variant (``label`` not ``root``) its K14 and K10 rows
    forward and K10's combine mode where it has one; the K12 interface
    read from the build's source."""
    from kubeflow_tpu_torch.ops import moe, norms

    so, nso = ctypes.CDLL(lib), ctypes.CDLL(side_lib(lib, "rms_norm.cu"))
    with open(os.path.join(root, CSRC, "moe.cu")) as f:
        scratch = "void* gates, void* pos" in f.read()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = so.kftpu_moe_route
    fn.restype = i
    fn.argtypes = [p, i, ll, i, i, i, i] + [p] * (10 if scratch else 8)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def route():
        def call(logits, C):
            T, E = logits.shape
            dev = logits.device
            out = moe.Routing(*(torch.empty(n, dtype=d, device=dev) for n, d in (
                (T, torch.int32), (T, torch.int32), (T, torch.float32),
                (T, torch.float32), (E * C, torch.int32),
                (E * C, torch.bfloat16), (1, torch.float32))))
            # The earlier interface's scratch: the gates and positions,
            # alive until the launch is queued.
            gates = torch.empty(T * E, device=dev) if scratch else None
            pos = torch.empty(2 * T, dtype=torch.int32, device=dev) \
                if scratch else None
            tail = [gates.data_ptr(), pos.data_ptr()] if scratch else []
            rc = fn(logits.data_ptr(), 1, T, E, 1, C, 1,
                    *(t.data_ptr() for t in out), *tail, stream())
            if rc != 0:
                raise RuntimeError(f"route launch failed: CUDA error {rc}")
            return out
        return call

    combine_fn = so.kftpu_moe_combine     # K14's entry is unchanged
    combine_fn.restype = i
    combine_fn.argtypes = [i, p, p, p, p, p, p, ll, ll, i, p]
    rows_fn = norms.bind_add(nso)[2]
    fused_fn = (norms.bind_combine(nso)
                if hasattr(nso, "kftpu_add_rms_norm_fwd_combine") else None)

    def pair(x, c, w):
        T, M = x.shape
        h = torch.empty_like(x)
        rc = combine_fn(1, c.y.data_ptr(), c.g1.data_ptr(), c.g2.data_ptr(),
                        c.dest1.data_ptr(), c.dest2.data_ptr(), h.data_ptr(),
                        T, c.y.shape[0], M, stream())
        r, y = torch.empty_like(x), torch.empty_like(x)
        rstd = torch.empty(T, device=x.device)
        rc |= rows_fn(1, 1, x.data_ptr(), h.data_ptr(), w.data_ptr(),
                      r.data_ptr(), y.data_ptr(), rstd.data_ptr(), T, M,
                      1e-6, stream())
        if rc != 0:
            raise RuntimeError("K14 or K10 launch failed")
        return r, y

    def fused(x, c, w):
        T, M = x.shape
        r, y = torch.empty_like(x), torch.empty_like(x)
        rstd = torch.empty(T, device=x.device)
        rc = fused_fn(1, 1, x.data_ptr(), c.y.data_ptr(), c.g1.data_ptr(),
                      c.g2.data_ptr(), c.dest1.data_ptr(),
                      c.dest2.data_ptr(), c.y.shape[0], w.data_ptr(),
                      r.data_ptr(), y.data_ptr(), rstd.data_ptr(), T, M,
                      1e-6, stream())
        if rc != 0:
            raise RuntimeError(f"combine launch failed: CUDA error {rc}")
        return r, y

    if label != root:
        return {"route": {label: route()}, "combine": {}}
    calls = {"route": {root: route()}, "combine": {f"{root} K14+K10": pair}}
    if fused_fn is not None:
        calls["combine"][f"{root} combine mode"] = fused
    return calls


def run_moe(name: str, calls: dict) -> bool:
    """K12 at a MOE_CASES case, or the combine path at a COMBINE_SHAPES
    row count: every build's check, then device ms in turns."""
    from chip_smoke import MOE_CASES, MOE_E, MOE_M
    from kubeflow_tpu_torch.ops import moe
    from kubeflow_tpu_torch.parallel.moe import Top2GateConfig

    gen = torch.Generator(device="cuda").manual_seed(20)

    def logits_for(T):
        lg = torch.randn(T, MOE_E, generator=gen, device="cuda")
        lg[:, 1] += 3.0
        return lg.bfloat16()

    ok = True
    if name in dict(MOE_CASES):
        T = dict(MOE_CASES)[name]
        C = Top2GateConfig(num_experts=MOE_E).capacity(T)
        logits = logits_for(T)
        want = moe.route_reference(logits, 1, C, torch.bfloat16)
        fns = {}
        for label, call in calls["route"].items():
            if label.rsplit(":", 1)[-1].startswith("nb") and T <= 32:
                continue              # the warp form: no blocks a group
            got = call(logits, C)
            same = all(torch.equal(a, b) for a, b in zip(got, want)) and \
                all(torch.equal(a, b) for a, b in zip(got, call(logits, C)))
            ok &= same
            print(f"K12 {name} {label}: bitwise the plain version and two "
                  f"calls equal: {same}{'' if same else '  FAIL'}",
                  flush=True)
            fns[label] = call
        graphs = {label: capture(lambda c=c: c(logits, C), 10)
                  for label, c in fns.items()}
        times = turns(graphs, 10)
        print(f"K12 {name} (T {T}, E {MOE_E}, C {C}) device ms per call "
              f"(median / least of 6 turns): " + "; ".join(
                  f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
                  for label, t in times.items()), flush=True)
        return ok
    rows = COMBINE_SHAPES[name]
    M, C = MOE_M, max(1, rows // 4)
    S = MOE_E * C
    r = moe.route_reference(logits_for(rows), 1, C, torch.bfloat16)
    kept = int((r.dest1 < S).sum() + (r.dest2 < S).sum())
    call_bytes = (3 * rows + kept) * M * 2
    n = max(1, -(-int(2 * L2_BYTES) // call_bytes))
    w = (1 + 0.1 * torch.randn(M, generator=gen, device="cuda")).bfloat16()
    sets = [(torch.randn(rows, M, generator=gen, device="cuda").bfloat16(),
             moe.Combine(torch.randn(S, M, generator=gen,
                                     device="cuda").bfloat16(),
                         r.g1, r.g2, r.dest1, r.dest2)) for _ in range(n)]
    want = moe.combine_rows_reference(*sets[0][1])
    want_r = sets[0][0] + want
    first = None
    for label, call in calls["combine"].items():
        got = call(sets[0][0], sets[0][1], w)
        first = first or got
        same = torch.equal(got[0], want_r) and torch.equal(got[1], first[1])
        ok &= same
        print(f"combine {name} {label}: the sum bitwise the plain version, "
              f"y bitwise the first build's: {same}{'' if same else '  FAIL'}",
              flush=True)
    order = list(range(n)) * max(1, -(-10 // n))

    def rotating(call):
        turn = itertools.cycle(order)

        def run():
            x, c = sets[next(turn)]
            return call(x, c, w)
        return run

    graphs = {label: capture(rotating(call), len(order))
              for label, call in calls["combine"].items()}
    times = turns(graphs, len(order))
    nbytes = call_bytes + 2 * M + 16 * rows
    print(f"combine {name} ([{rows}, {M}] bf16, {kept} of {2 * rows} choices "
          f"kept; cold, {n} sets) device ms per call (median / least of 6 "
          f"turns): " + "; ".join(
              f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
              for label, t in times.items())
          + f"; bound {1e3 * nbytes / PEAK_BYTES_PER_S:.6f} (bytes)",
          flush=True)
    del graphs, sets
    return ok


# name -> (rows an expert, N, K): chip_smoke.py's K15 cases, E = K15_E;
# the fused gate/up launch's at F = 14336, K = 4096.
EXPERT_SHAPES = {case: (r, n, k) for case, r, n, k in K15_CASES}
EXPERT_SHAPES.update({case: (r, 14336, 4096)
                      for case, r, _, _, _ in K15_FUSED_CASES})


def parse_variant(v: str):
    """``bm128``, ``o2``, ``bm256o1`` -> (bm, order), 0 where the variant
    leaves the plan's choice."""
    import re

    m = re.fullmatch(r"(?:bm(64|128|256))?(?:o([12]))?", v)
    if m is None or not v:
        raise ValueError(f"unknown experts variant {v!r}")
    return tuple(int(g or 0) for g in m.groups())


def experts_callers(root: str, lib: str, variants: list) -> dict:
    """The build's K15 as ``{label: call(x, q, scale) -> y}``: its own plan
    (label ``root``), and each variant where the build has the config
    entry (label ``root:variant``)."""
    so = ctypes.CDLL(lib)
    plain = so.kftpu_int8_experts
    plain.restype = ctypes.c_int
    plain.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    config = getattr(so, "kftpu_int8_experts_config", None)
    if config is not None:
        config.restype = ctypes.c_int
        config.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]

    def caller(cfg):
        def call(x, q, scale):
            e, r, k = x.shape
            n = q.shape[1]
            y = torch.empty(e, r, n, dtype=torch.bfloat16, device=x.device)
            args = (x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                    y.data_ptr(), e, r, n, k)
            stream = torch.cuda.current_stream().cuda_stream
            rc = (plain(*args, stream) if cfg is None
                  else config(*args, *cfg, stream))
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return y
        call.cfg = cfg
        return call

    calls = {root: caller(None)}
    if config is not None:
        for v in variants:
            calls[f"{root}:{v}"] = caller(parse_variant(v))
    calls[root].chain = chain_caller(lib, plain)
    calls[root].fused = fused_caller(so)
    return calls


def chain_caller(lib: str, product):
    """The build's launches that K15's fused gate/up launch replaces, as
    ``chain(x, slot_tok, slot_valid, (gate_q, gate_s, up_q, up_s), R) ->
    h``: its K13 (moe.cu's gather), its K15 ``product`` for gate and for
    up, its K9 (swiglu.cu's forward)."""
    from kubeflow_tpu_torch.ops import moe, swiglu

    gather = moe.bind(ctypes.CDLL(side_lib(lib, "moe.cu")))[1]
    fwd = swiglu.bind(ctypes.CDLL(side_lib(lib, "swiglu.cu")))[0]

    def chain(x, slot_tok, slot_valid, weights, R):
        T, K = x.shape
        S = slot_tok.numel()
        E, F = S // R, weights[0].shape[1]
        stream = torch.cuda.current_stream().cuda_stream
        x_e = torch.empty(S, K, dtype=torch.bfloat16, device=x.device)
        g, u, h = (torch.empty(E, R, F, dtype=torch.bfloat16,
                               device=x.device) for _ in range(3))
        rcs = [gather(1, x.data_ptr(), slot_tok.data_ptr(),
                      slot_valid.data_ptr(), x_e.data_ptr(), S, K, stream)]
        for q, s, y in ((*weights[:2], g), (*weights[2:], u)):
            rcs.append(product(x_e.data_ptr(), q.data_ptr(), s.data_ptr(),
                               y.data_ptr(), E, R, F, K, stream))
        rcs.append(fwd(1, g.data_ptr(), u.data_ptr(), h.data_ptr(), S, F, F,
                       F, stream))
        if any(rcs):
            raise RuntimeError(f"chain launch failed: CUDA errors {rcs}")
        return h
    return chain


def fused_caller(so):
    """The build's fused gate/up launch as ``fused(x, slot_tok, slot_valid,
    weights, R) -> h``, or None where its source has none."""
    fn = getattr(so, "kftpu_int8_experts_swiglu", None)
    if fn is None:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]

    def fused(x, slot_tok, slot_valid, weights, R):
        T, K = x.shape
        E, F = slot_tok.numel() // R, weights[0].shape[1]
        h = torch.empty(E, R, F, dtype=torch.bfloat16, device=x.device)
        rc = fn(*(t.data_ptr() for t in (x, slot_tok, slot_valid, *weights,
                                         h)), T, E, R, F, K,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused launch failed: CUDA error {rc}")
        return h
    return fused


def run_experts_fused(name: str, calls: dict) -> bool:
    """Every build's chain of four launches and, where it has one, its
    fused gate/up launch at a K15_FUSED_CASES case: all bitwise equal and
    within 1e-2 x max|plain| of the plain chain, then device ms per call
    in turns beside the bound."""
    from kubeflow_tpu_torch.ops import int8_experts as ie
    from kubeflow_tpu_torch.ops import moe
    from kubeflow_tpu_torch.serving.engine import _quantize_expert_leaf

    R, G, C, T = next(c[1:] for c in K15_FUSED_CASES if c[0] == name)
    _, F, K = EXPERT_SHAPES[name]
    E = K15_E
    gen = torch.Generator(device="cuda").manual_seed(21)
    weights = []
    for _ in range(2):
        w = torch.randn(E, K, F, generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.02
        weights += _quantize_expert_leaf(w)
        del w
    logits = torch.randn(T, E, generator=gen, device="cuda")
    logits[:, 1] += 3.0                          # a hot expert: drops
    r = moe.route(logits.bfloat16(), G, C, torch.bfloat16)
    x = torch.randn(T, K, generator=gen, device="cuda").bfloat16()
    args = (x, r.slot_tok, r.slot_valid, weights, R)
    want = ie.int8_experts_swiglu_reference(x, r.slot_tok, r.slot_valid,
                                            *weights, R).float()
    top = want.abs().max().item()
    fns, ok, first = {}, True, None
    for label, call in calls.items():
        if call.cfg is not None:
            continue
        for kind, fn in (("chain", call.chain), ("fused", call.fused)):
            if fn is None:
                continue
            got = fn(*args)
            first = got if first is None else first
            err = (got.float() - want).abs().max().item()
            same = torch.equal(got, first) and torch.equal(got, fn(*args))
            good = err <= 1e-2 * top and same
            ok &= good
            print(f"{name} {label} {kind}: max err / max|plain| "
                  f"{err / top:.3e}; bitwise the first build's chain and "
                  f"twice: {same}{'' if good else '  FAIL'}", flush=True)
            fns[f"{label} {kind}"] = lambda fn=fn: fn(*args)
    del want
    graphs = {label: capture(fn, 10) for label, fn in fns.items()}
    times = turns(graphs, 10)
    nbytes = (2 * (E * F * K + 2 * F * K) + 2 * T * K + 6 * E * R
              + 2 * E * R * F)
    print(f"{name} (E {E}, R {R} = {G} x {C}, T {T}, F {F}, K {K}) device "
          f"ms per call (median / least of 6 turns): " + "; ".join(
              f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
              for label, t in times.items())
          + f"; bound {bytes_ms(nbytes):.5f} (bytes)", flush=True)
    del graphs, weights, x
    torch.cuda.empty_cache()
    return ok


def run_experts(name: str, calls: dict) -> bool:
    """Every build (and variant that applies) at one K15 case: the check,
    then device ms per call in turns beside the bound and torch.bmm."""
    from kubeflow_tpu_torch.ops import int8_experts as ie
    from kubeflow_tpu_torch.serving.engine import _quantize_expert_leaf

    r, n, k = EXPERT_SHAPES[name]
    e = K15_E
    gen = torch.Generator(device="cuda").manual_seed(15)
    w = torch.randn(e, k, n, generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.02
    q, scale = _quantize_expert_leaf(w)
    del w
    x = torch.randn(e, r, k, generator=gen, device="cuda").bfloat16()
    want = ie.int8_experts_reference(x, q, scale).float()
    top = want.abs().max().item()
    # A variant (the tiled kernel's plan) applies above 16 rows.
    calls = {label: call for label, call in calls.items()
             if call.cfg is None or r > 16}
    ok = True
    for label, call in calls.items():
        got = call(x, q, scale)
        err = (got.float() - want).abs().max().item()
        same = torch.equal(got, call(x, q, scale))
        good = err <= 1e-2 * top and same
        ok &= good
        print(f"{name} {label}: max err / max|plain| {err / top:.3e}; two "
              f"calls bitwise equal: {same}{'' if good else '  FAIL'}",
              flush=True)
    del want
    bound = int8_experts_bound_ms(e, r, n, k)[0]
    wt = ie.dequantize_experts(q, scale).transpose(1, 2).contiguous()
    per = 10 if r <= 16 else 2
    graphs = {label: capture(lambda c=call: c(x, q, scale), per)
              for label, call in calls.items()}
    graphs["torch.bmm (bf16 experts)"] = capture(lambda: torch.bmm(x, wt), per)
    times = turns(graphs, per)
    print(f"{name} (E {e}, R {r}, N {n}, K {k}) device ms per call (median "
          f"/ least of 6 turns): " + "; ".join(
              f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
              for label, t in times.items()) + f"; bound {bound:.5f}",
          flush=True)
    del graphs, wt, q, scale, x
    torch.cuda.empty_cache()
    return ok


def run_decode_paged(calls: dict) -> bool:
    """Each build with the block-table entry, paged and dense over the same
    rows, cold (pool sets whose live rows exceed twice the L2), in turns."""
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows
    from kubeflow_tpu_torch.ops.paged_attention import gather_cache

    calls = {label: c for label, c in calls.items() if c.paged is not None}
    if not calls:
        print("paged: no build has the block-table entry", flush=True)
        return True
    b, h, hkv, d = PAGED_B, DECODE_H, DECODE_HKV, DECODE_D
    nb = PAGED_L // PAGED_BS
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q = rand(b, 1, h, d)
    sk, sv = rand(b, PAGED_C, hkv, d), rand(b, PAGED_C, hkv, d)
    idx = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    rows = sum(PAGED_LENGTHS)
    in_order = torch.arange(b * nb, device="cuda").view(b, nb).int()
    ok = True
    for cache in ("bf16", "int8"):
        row_bytes = hkv * d * 2 * (2 if cache == "bf16" else 1) \
            + (hkv * 8 if cache == "int8" else 0)
        n_sets = max(2, -(-int(2 * L2_BYTES) // (rows * row_bytes)))
        sets = []
        for _ in range(n_sets):
            k, v = rand(b * nb + 1, PAGED_BS, hkv, d), \
                rand(b * nb + 1, PAGED_BS, hkv, d)
            ks = vs = None
            if cache == "int8":
                (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            tables = torch.randperm(b * nb, generator=gen, device="cuda")\
                .view(b, nb).int()
            sets.append(((k, v, ks, vs, tables),
                         gather_cache(tables, PAGED_BS, k, v, ks, vs)))
        runs = {}
        for label, call in calls.items():
            def dense(i, call=call):
                k, v, ks, vs = sets[i][1]
                return call(q, k, v, idx, ks, vs, sk, sv, PAGED_C)

            def paged(i, call=call, tables=None):
                k, v, ks, vs, shuffled = sets[i][0]
                return call.paged(q, k, v, idx, ks, vs, sk, sv, PAGED_C,
                                  shuffled if tables is None else tables,
                                  PAGED_BS)

            same = torch.equal(dense(0), paged(0))
            ok &= same
            print(f"paged {cache} {label}: paged bitwise equal to dense over "
                  f"the same rows: {same}{'' if same else '  FAIL'}",
                  flush=True)
            runs[f"{label} dense"], runs[f"{label} paged"] = dense, paged
            # The table in page order: the dense cache's addresses, read
            # through the table (what the lookup itself costs).
            runs[f"{label} paged in order"] = functools.partial(
                paged, tables=in_order)
        order = list(range(n_sets)) * max(1, -(-10 // n_sets))

        def rotating(fn):
            turn = itertools.cycle(order)
            return lambda: fn(next(turn))

        graphs = {label: capture(rotating(fn), len(order))
                  for label, fn in runs.items()}
        times = turns(graphs, len(order))
        nbytes = rows * row_bytes + b * hkv * PAGED_C * d * 4 + 4 * b * h * d
        print(f"paged {cache} staged cold ({n_sets} sets) device ms per call "
              f"(median / least of 6 turns): " + "; ".join(
                  f"{label} {statistics.median(t):.5f} / {min(t):.5f}"
                  for label, t in times.items())
              + f"; bound {1e3 * nbytes / PEAK_BYTES_PER_S:.5f} (bytes)",
              flush=True)
        del graphs, sets
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="bwd")
    ap.add_argument("--shapes", default=None,
                    help="bwd: train,s512,d64 (default train,s512); "
                    "decode: served,long,even,one,paged (default served,"
                    "long); "
                    "int8: q,kv,o,gate,down,lm_head,qkv,gateup,m64,m512,"
                    "m1024,m4096,step (default the first eight); "
                    "experts: " + ",".join(EXPERT_SHAPES) + " (default "
                    "all); moe: decode,prefill," + ",".join(COMBINE_SHAPES)
                    + " (default all)")
    ap.add_argument("--variants", default="",
                    help="experts: tiled launch plans of a build that has "
                    "kftpu_int8_experts_config, e.g. bm128,o1,bm256o2; "
                    "moe: K12's group form at a fixed number of blocks a "
                    "group, e.g. nb1,nb8")
    args = ap.parse_args()
    decode = args.kernel == "decode"
    shapes = args.shapes or {
        "decode": "served,long", "bwd": "train,s512",
        "int8": "q,kv,o,gate,down,lm_head,qkv,gateup",
        "experts": ",".join(EXPERT_SHAPES),
        "moe": ",".join(["decode", "prefill", *COMBINE_SHAPES])}[args.kernel]
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    variants = [v for v in args.variants.split(",") if v]
    with tempfile.TemporaryDirectory(prefix="kernel_ab-") as out_dir:
        libs = [os.path.join(out_dir, f"{args.kernel}_{i}.so")
                for i in range(len(args.dirs))]
        # (root, lib, label, variant source or None)
        builds = [(root, lib, root, None)
                  for root, lib in zip(args.dirs, libs)]
        if args.kernel == "moe":
            for root in args.dirs:
                for v in variants:
                    path = moe_variant(root, out_dir, v, len(builds))
                    if path is None:
                        print(f"{root}: no K12 plan line, no {v}",
                              flush=True)
                        continue
                    builds.append((root, os.path.join(
                        out_dir, f"moe_{len(builds)}.so"), f"{root}:{v}",
                        path))
        with ThreadPoolExecutor(len(builds)) as pool:      # one nvcc each
            reports = list(pool.map(build, [b[0] for b in builds],
                                    [b[1] for b in builds],
                                    [args.kernel] * len(builds),
                                    [b[3] for b in builds]))
        for (_, _, label, _), report in zip(builds, reports):
            print(f"build {label}:\n" + "\n".join(report), flush=True)
        if decode:
            fns = {root: decode_caller(root, lib)
                   for root, lib in zip(args.dirs, libs)}
        elif args.kernel == "int8":
            fns = {root: int8_caller(lib)
                   for root, lib in zip(args.dirs, libs)}
        elif args.kernel == "moe":
            fns = {"route": {}, "combine": {}}
            for root, lib, label, _ in builds:
                for key, part in moe_callers(root, lib, label).items():
                    fns[key].update(part)
        elif args.kernel == "experts":
            fns = {label: call for root, lib in zip(args.dirs, libs)
                   for label, call in experts_callers(
                       root, lib, variants).items()}
        else:
            fns = {root: fa.bind_bwd(ctypes.CDLL(lib))
                   for root, lib in zip(args.dirs, libs)}
    ok, step = True, {}
    for name in shapes.split(","):
        if args.kernel == "int8" and name == "step":
            ok &= run_int8_step(fns)
        elif args.kernel == "int8":
            ok &= run_int8(name, fns, step)
        elif args.kernel == "experts":
            ok &= (run_experts_fused(name, fns) if name.startswith("fused")
                   else run_experts(name, fns))
        elif args.kernel == "moe":
            ok &= run_moe(name, fns)
        else:
            ok &= (run_decode_paged(fns) if name == "paged" else
                   run_decode(name, fns)) if decode else run_shape(name, fns)
        torch.cuda.empty_cache()
    if step:
        print("int8 products of a decode step at these shapes (ms, median "
              "x launches a step; q/k/v and gate/up apart, or grouped): "
              + "; ".join(f"{label} {mode} {kind} {v:.4f}" for
                          (label, mode, kind), v in sorted(step.items())),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

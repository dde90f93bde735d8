"""A/B device timing of builds of the flash-attention backward (K2) on one
NVIDIA GPU: ``python3 kernel_ab.py DIR [DIR ...] [--shapes train,s512]``.

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
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa

SHAPES = {             # B, S, H, Hkv, D
    "train": (12, 2048, 16, 8, 128),
    "s512": (8, 512, 16, 8, 128),
    "d64": (8, 512, 16, 8, 64),
}
TOL = 2e-2             # the bf16 bound of chip_smoke.py and the card tests
SOURCE = os.path.join("kubeflow_tpu_torch", "ops", "csrc",
                      "flash_attention_bwd.cu")


def kernel_name(name: str) -> str:
    """``flash_bwd_...`` and its template arguments, from a mangled or a
    demangled kernel name."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[max(name.find("flash_bwd"), 0):]
    return name.split("EEEEE")[0].split("(")[0].split("'")[0]


def build(root: str, lib: str) -> list:
    """Compile ``root``'s K2 source into ``lib``; returns ptxas's report
    lines for the bf16 kernels."""
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
         os.path.join(root, SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {root}:\n{proc.stderr}")
    report, bf16 = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            bf16 = "bf16" in line
            if bf16:
                report.append("  " + kernel_name(line.split("'")[1]))
        elif bf16 and ("registers" in line or "spill" in line):
            report.append("    " + line.split(":", 1)[-1].strip())
        elif "C75" in line:     # e.g. C7512: wgmma serialised for lack of registers
            report.append(f"    {line.split(')')[0].split('(')[-1]} in "
                          f"{kernel_name(line.split(chr(39))[1])}")
    return report


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

    graphs = {}
    for label, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                call(fn)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(10):
                call(fn)
        graphs[label] = graph
    times = {label: [] for label in fns}
    order = list(fns)
    for rnd in range(6):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            graphs[label].replay()
            start.record()
            graphs[label].replay()
            graphs[label].replay()
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / 20)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--shapes", default="train,s512")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="kernel_ab-") as out_dir:
        libs = [os.path.join(out_dir, f"k2_{i}.so")
                for i in range(len(args.dirs))]
        with ThreadPoolExecutor(len(args.dirs)) as pool:   # one nvcc each
            reports = list(pool.map(build, args.dirs, libs))
        for root, report in zip(args.dirs, reports):
            print(f"build {root}:\n" + "\n".join(report), flush=True)
        fns = {root: fa.bind_bwd(ctypes.CDLL(lib))
               for root, lib in zip(args.dirs, libs)}
    ok = True
    for name in args.shapes.split(","):
        ok &= run_shape(name, fns)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

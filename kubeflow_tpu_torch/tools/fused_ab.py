"""A/B device timing of builds of the adafactor update (K11) and of the
residual add + RMSNorm forward (K10) on one NVIDIA GPU:
``python3 -m kubeflow_tpu_torch.tools.fused_ab DIR [DIR ...]``.

Each DIR is the root of a checkout, or of a copy of its
``kubeflow_tpu_torch/ops`` (for instance ``git archive <rev>
kubeflow_tpu_torch/ops | tar -x -C DIR``, into a directory that
``.gitignore`` lists); ``.`` is this checkout. Every build's
``adafactor.cu`` and ``rms_norm.cu`` are compiled with the flags of
``ops/_build.py`` (nvcc calls started together; ptxas's register and
spill lines of the tile passes are printed), and its
``ops/adafactor.py`` is loaded beside this checkout's modules and bound
to that build.

K11: the ~700M training model's 111 tensors (vocab 32000, embed 2048,
12 layers, 16/8 heads of 128, MLP 5632; the JAX leaves stacked over the
layers), bf16 params and grads from seed 15, f32 moments of earlier
steps, clipped (max_norm 1). A build whose update takes the norm (the
first K11) runs as its trainer ran it: K5's global norm, then K11; a
build that computes the norm runs alone. Each build is held against its
own plain version (params within one bf16 ulp, two calls bitwise equal),
then the builds are timed in CUDA-graph replays (two steps a replay),
taking turns (forward order, then reverse; six rounds: the median and
the least per build), and each build's kernels are timed apart by name
under torch.profiler.

K10: each build's forward at llama3-8b's serving rows, [8, 4096] and
[48, 4096] bf16, cold (calls rotating over input sets larger than twice
the L2, as the served step finds them), in turns; through the rows
kernel where the build has one (``kftpu_add_rms_norm_fwd_rows``), else
its block-a-row kernel; the same for K6 (``kftpu_rms_norm_fwd``). With
``--sweep``, this checkout's two K10 and K6 forwards at 8 to 4096 rows
of 4096 and of 2048: where the rows kernel stops paying
(``ops/norms.py::ROWS_MAX``). With ``--pdl``, programmatic dependent
launch of the K10 rows kernel, measured on a variant of this checkout's
``rms_norm.cu`` that this script writes and builds (PDL_LOADS: w loaded
before ``griddepcontrol.wait``, x and h after it; PDL_ENTRY: a
``cudaLaunchKernelEx`` launch with programmatic stream serialisation):
llama3-8b's o_proj at 8 rows (``torch.mm`` on 32 layers' bf16 weights)
each followed by K10, one graph a way, in turns: the shipped kernel, the
variant launched plainly, the variant with PDL; outputs bitwise equal.

Prints the card's name and power limit first. Exits 2 without CUDA and 1
when a build disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import importlib.util
import inspect
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import norms
from kubeflow_tpu_torch.ops import optimizer as fused

OPS = os.path.join("kubeflow_tpu_torch", "ops")
SOURCES = ("adafactor.cu", "rms_norm.cu")
MODEL_KW = dict(vocab_size=32000, embed_dim=2048, num_layers=12,
                num_heads=16, num_kv_heads=8, head_dim=128, mlp_dim=5632,
                max_seq_len=2048, scan_layers=True)
#: K11's passes, first and redesigned, by their device kernels' names.
PASSES = ("::tile_stats", "::norm_reduce", "::moments", "::row_factors",
          "::tile_u2", "::leaf_sums", "::apply_update", "::norm_partial",
          "::norm_final")
L2_BYTES = 50e6
SWEEP_ROWS = (8, 16, 32, 48, 64, 96, 128, 256, 512, 1024, 2048, 4096)


def build(root: str, out_dir: str, tag: str) -> dict:
    """Compile ``root``'s two sources; returns {source: library} and
    prints ptxas's register and spill lines of the K11 tile passes."""
    libs, report = {}, []
    for source in SOURCES:
        lib = os.path.join(out_dir, f"{tag}_{source[:-3]}.so")
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(root, OPS, "csrc", source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}/{source}:\n"
                               f"{proc.stderr}")
        libs[source] = lib
        keep = False
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling entry" in line:
                name = line.split("'")[1]
                keep = any(k in name for k in ("tile_", "apply_update",
                                                "fwd_rows"))
                if keep:
                    report.append(f"  {source}: {name[:60]}")
            elif keep and ("registers" in line or "spill" in line):
                report.append("    " + line.split(":", 1)[-1].strip())
    print(f"build {root}:\n" + "\n".join(report), flush=True)
    return libs


def adafactor_module(root: str, lib: str):
    """``root``'s ops/adafactor.py as a module of its own, bound to
    ``lib``."""
    name = f"adafactor_{abs(hash(root))}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, OPS, "adafactor.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod           # dataclasses look their module up
    spec.loader.exec_module(mod)
    mod._kernel_fn = functools.lru_cache(maxsize=None)(
        lambda: mod.bind(ctypes.CDLL(lib)))
    return mod


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


def turns(graphs: dict, per_replay: int, rounds: int = 6) -> dict:
    """Device ms per call of each label's graph, in turns: forward order,
    then reverse, ``rounds`` times; each turn times two replays after one
    untimed. {label: (median, least)}."""
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
    return {k: (statistics.median(v), min(v)) for k, v in times.items()}


def split_ms(fn, runs: int = 3) -> dict:
    """Device ms a call of each of PASSES that ``fn`` launches, from a
    short torch.profiler pass: the mean event times the events a call (the
    count over the runs, rounded: a session can lose one event)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in PASSES:
        own = [e for e in events if name in e.key]
        total = sum(e.device_time_total for e in own)
        count = sum(e.count for e in own)
        if total > 0:
            out[name.strip(":")] = (total / 1e3 / count
                                    * max(1, round(count / runs)))
    return out


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| in bf16 ulps of max(|want|, 2^-8 max |want|)."""
    w = want.float()
    scale = w.abs().clamp_min(2 ** -8 * float(w.abs().max()))
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(((got.float() - w).abs() / ulp).max())


def k11_case():
    from kubeflow_tpu_torch.models.layout import jax_leaves
    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(**MODEL_KW)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in Llama(cfg).named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(15)
    mk = lambda s, sc: (torch.randn(s, generator=gen, device="cuda")  # noqa: E731
                        * sc).bfloat16()
    return ({n: mk(s, 0.02) for n, s in shapes.items()},
            {n: mk(s, 1e-4) for n, s in shapes.items()}, jax_leaves(cfg))


def run_k11(mods: dict) -> bool:
    params, grads, leaves = k11_case()
    n = sum(p.numel() for p in params.values())
    ok, steps = True, {}
    for root, mod in mods.items():
        state = mod.init_state(params, leaves)
        gen = torch.Generator(device="cuda").manual_seed(16)
        for key in ("v_row", "v_col", "v"):
            for m in state[key].values():
                m.copy_(torch.rand(m.shape, generator=gen, device="cuda")
                        * 1e-8 + 1e-10)
        hyper = mod.Hyper(max_norm=1.0, count=3, lr=3e-4, weight_decay=0.1)
        takes_norm = "norm" in inspect.signature(mod.update).parameters

        def step(mod=mod, state=state, hyper=hyper, takes_norm=takes_norm,
                 p=params):
            if takes_norm:
                norm = fused.global_norm(list(grads.values()))
                mod.update(p, grads, state, leaves, norm, hyper)
                return norm
            return mod.update(p, grads, state, leaves, hyper)

        copies = [({k: t.clone() for k, t in params.items()},
                   {k: ({m: t.clone() for m, t in v.items()}
                        if isinstance(v, dict) else v)
                    for k, v in state.items()}) for _ in range(3)]
        for p_, s_ in copies[:2]:
            step(state=s_, p=p_)
        p_, s_ = copies[2]
        args = (p_, grads, s_, leaves)
        if takes_norm:
            mod.update_reference(*args, fused.global_norm_reference(
                list(grads.values())), hyper)
        else:
            mod.update_reference(*args, hyper)
        worst = max(ulps(copies[0][0][k], p_[k]) for k in params)
        same = all(torch.equal(copies[0][0][k], copies[1][0][k])
                   for k in params)
        print(f"K11 {root}: {'takes K5 norm' if takes_norm else 'own norm'}"
              f"; params {worst:.2f} ulp of its plain version, two calls "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        ok &= worst <= 1 and same
        del copies
        torch.cuda.empty_cache()
        steps[root] = (step, split_ms(step))
    graphs = {root: capture(fn, 2) for root, (fn, _) in steps.items()}
    for root, (med, least) in turns(graphs, 2).items():
        split = steps[root][1]
        print(f"K11 {root}: {med:.4f} ms a step (least {least:.4f}); "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; bound {6 * n / 3.35e12 * 1e3:.4f} (bytes)", flush=True)
    return ok


def k10_callers(libs: dict) -> dict:
    """{root: (K10 forward, K6 forward, rows kernel?)} through each build's
    C entries."""
    out = {}
    for root, lib in libs.items():
        cdll = ctypes.CDLL(lib["rms_norm.cu"])
        rows = hasattr(cdll, "kftpu_add_rms_norm_fwd_rows")
        k6 = norms._entry(cdll, "kftpu_rms_norm_fwd_rows" if rows
                          else "kftpu_rms_norm_fwd", 4, norms._FWD_TAIL)
        k10 = norms._entry(cdll, "kftpu_add_rms_norm_fwd_rows" if rows
                           else "kftpu_add_rms_norm_fwd", 6, norms._FWD_TAIL)
        out[root] = (k10, k6, rows)
    return out


@dataclasses.dataclass
class RowsSet:
    x: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor
    y: torch.Tensor
    rstd: torch.Tensor


def row_sets(rows: int, E: int, gen) -> list:
    call = 4 * rows * E * 2 + 2 * E
    n = max(1, int(2 * L2_BYTES // call) + 1)
    mk = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                device="cuda").bfloat16()
    return [RowsSet(mk(rows, E), mk(rows, E), (1 + 0.1 * mk(E)).bfloat16(),
                    mk(rows, E), mk(rows, E),
                    torch.empty(rows, device="cuda")) for _ in range(n)]


def rows_call(fn, sets, add: bool):
    turn = iter(range(1 << 30))

    def call():
        s = sets[next(turn) % len(sets)]
        rows, E = s.x.shape
        ptrs = ([s.x, s.h, s.w, s.r, s.y, s.rstd] if add
                else [s.x, s.w, s.y, s.rstd])
        rc = fn(1, 1, *(t.data_ptr() for t in ptrs), rows, E, 1e-6,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"forward launch failed: CUDA error {rc}")
    return call


def run_k10(callers: dict, sweep: bool) -> bool:
    gen = torch.Generator(device="cuda").manual_seed(17)
    ok = True
    for rows in (8, 48):
        sets = row_sets(rows, 4096, gen)
        s = sets[0]
        want_r, want_y, _ = norms.add_rms_norm_reference(s.x, s.h, s.w,
                                                         eps=1e-6)
        graphs = {}
        for root, (k10, k6, has_rows) in callers.items():
            rows_call(k10, sets[:1], True)()
            torch.cuda.synchronize()
            err = ulps(s.y, want_y)
            bitwise = torch.equal(s.r, want_r)
            ok &= err <= 1 and bitwise
            print(f"K10 {root} [{rows}, 4096] "
                  f"({'rows kernel' if has_rows else 'a block a row'}): "
                  f"sum {'bitwise' if bitwise else 'DIFFERS'}, y "
                  f"{err:.2f} ulp", flush=True)
            calls = 2 * len(sets)
            graphs[f"K10 {root}"] = capture(rows_call(k10, sets, True),
                                            calls)
            graphs[f"K6 {root}"] = capture(rows_call(k6, sets, False), calls)
        for label, (med, least) in turns(graphs, 2 * len(sets)).items():
            print(f"{label} [{rows}, 4096] cold: {med * 1e3:.3f} us a launch "
                  f"(least {least * 1e3:.3f})", flush=True)
        del sets, graphs
        torch.cuda.empty_cache()
    for E in ((4096, 2048) if sweep else ()):
        for rows in SWEEP_ROWS:
            sets = row_sets(rows, E, gen)
            graphs = {}
            for add, name in ((True, "K10"), (False, "K6")):
                for by_rows in (True, False):
                    fns = (norms._add_kernel_fns() if add
                           else norms._kernel_fns())
                    fn = fns[2 if by_rows else 0]
                    graphs[f"{name} {'rows' if by_rows else 'block'}"] = \
                        capture(rows_call(fn, sets, add), 2 * len(sets))
            res = turns(graphs, 2 * len(sets), rounds=4)
            print(f"sweep [{rows}, {E}] cold, us a launch: " + "; ".join(
                f"{k} {v[0] * 1e3:.3f}" for k, v in res.items()),
                flush=True)
            del sets, graphs
            torch.cuda.empty_cache()
    return ok


PDL_LOADS = ("""  if (live) {                           // x, h and w in flight together
    load8(x + at, v);
    if (kAdd) load8(h + at, hv);
    load8(w + threadIdx.x * 8, wv);
  }""", """  if (live) load8(w + threadIdx.x * 8, wv);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (live) {
    load8(x + at, v);
    if (kAdd) load8(h + at, hv);
  }""")
PDL_ENTRY = """
extern "C" int kftpu_add_rms_norm_fwd_rows_pdl(int, int, const void* x, const void* h,
                                               const void* w, void* res, void* y, void* rstd,
                                               long long rows, int E, float eps, void* stream) {
  using B = __nv_bfloat16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows));
  cfg.blockDim = dim3((E / 8 + 31) / 32 * 32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, add_rmsnorm_fwd_rows<B, B>, static_cast<const B*>(x),
                            static_cast<const B*>(h), static_cast<const B*>(w),
                            static_cast<B*>(res), static_cast<B*>(y),
                            static_cast<float*>(rstd), E, eps);
}
"""


def pdl_variant(out_dir: str):
    """This checkout's rms_norm.cu with PDL_LOADS and PDL_ENTRY, built
    beside the shipped library; None where its rows kernel's loads read
    otherwise."""
    src_dir = os.path.join(out_dir, "pdl_csrc")
    os.makedirs(src_dir, exist_ok=True)
    csrc = os.path.join(OPS, "csrc")
    with open(os.path.join(csrc, "rms_norm.cu")) as f:
        text = f.read()
    if text.count(PDL_LOADS[0]) != 1:
        return None
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            with open(os.path.join(csrc, name)) as f, \
                    open(os.path.join(src_dir, name), "w") as g:
                g.write(f.read())
    src = os.path.join(src_dir, "rms_norm.cu")
    with open(src, "w") as f:
        f.write(text.replace(*PDL_LOADS) + PDL_ENTRY)
    lib = os.path.join(out_dir, "pdl_rms_norm.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the PDL variant:\n{proc.stderr}")
    return ctypes.CDLL(lib)


def run_pdl(out_dir: str) -> bool:
    variant = pdl_variant(out_dir)
    if variant is None:
        print("pdl: the rows kernel's loads read otherwise; skipped",
              flush=True)
        return True
    fns = {"shipped": norms._add_kernel_fns()[2],
           "variant plain": norms._entry(
               variant, "kftpu_add_rms_norm_fwd_rows", 6, norms._FWD_TAIL),
           "variant pdl": norms._entry(
               variant, "kftpu_add_rms_norm_fwd_rows_pdl", 6,
               norms._FWD_TAIL)}
    gen = torch.Generator(device="cuda").manual_seed(18)
    layers, E = 32, 4096
    mk = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                device="cuda").bfloat16()
    ws = [mk(E, E) * 0.02 for _ in range(layers)]    # 1 GB: past the L2
    norm_w = [(1 + 0.1 * mk(E)).bfloat16() for _ in range(layers)]
    a, x = mk(8, E), mk(8, E)
    empty = lambda *s, dt=torch.bfloat16: torch.empty(  # noqa: E731
        *s, device="cuda", dtype=dt)
    outs = {k: ([empty(8, E) for _ in range(layers)],
                [empty(8, E) for _ in range(2 * layers)],
                empty(layers, 8, dt=torch.float32)) for k in fns}

    def chain(kind):
        hs, ys, rstd = outs[kind]

        def run():
            for i in range(layers):
                torch.mm(a, ws[i].t(), out=hs[i])
                rc = fns[kind](1, 1, x.data_ptr(), hs[i].data_ptr(),
                               norm_w[i].data_ptr(), ys[2 * i].data_ptr(),
                               ys[2 * i + 1].data_ptr(), rstd[i].data_ptr(),
                               8, E, 1e-6,
                               torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{kind} K10 launch: CUDA error {rc}")
        return run

    graphs = {k: capture(chain(k), 1) for k in fns}
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize()
    want = outs["shipped"][1] + [outs["shipped"][2]]
    same = all(all(torch.equal(p, q) for p, q in zip(
        want, outs[k][1] + [outs[k][2]])) for k in fns)
    res = turns(graphs, layers)
    print(f"pdl: {layers} x (o_proj mm [8, {E}] x [{E}, {E}] bf16, then K10 "
          f"rows [8, {E}]) a replay, us a pair: " + "; ".join(
              f"{k} {v[0] * 1e3:.3f} (least {v[1] * 1e3:.3f})"
              for k, v in res.items())
          + f"; outputs {'bitwise equal' if same else 'DIFFER'}", flush=True)
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--sweep", action="store_true",
                    help="this checkout's K10 and K6 forwards, rows kernel "
                    "against a block a row, at 8 to 4096 rows")
    ap.add_argument("--skip-k11", action="store_true")
    ap.add_argument("--pdl", action="store_true",
                    help="programmatic dependent launch of the K10 rows "
                    "kernel behind a product, on a variant of this "
                    "checkout's rms_norm.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="fused_ab-") as out_dir:
        with ThreadPoolExecutor(len(args.dirs)) as pool:
            built = list(pool.map(build, args.dirs,
                                  [out_dir] * len(args.dirs),
                                  [f"b{i}" for i in range(len(args.dirs))]))
        libs = dict(zip(args.dirs, built))
        ok = True
        if not args.skip_k11:
            ok &= run_k11({root: adafactor_module(root, lib["adafactor.cu"])
                           for root, lib in libs.items()})
            torch.cuda.empty_cache()
        ok &= run_k10(k10_callers(libs), args.sweep)
        if args.pdl:
            ok &= run_pdl(out_dir)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

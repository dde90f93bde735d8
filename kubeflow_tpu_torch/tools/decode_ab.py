"""A/B of the served decode step across checkouts on one NVIDIA GPU:
``python3 kubeflow_tpu_torch/tools/decode_ab.py DIR [DIR ...]
[--configs bf16,int8_kv,...] [--rounds 8]``.

Each DIR is the root of a checkout whose ``kubeflow_tpu_torch`` is
measured (``.`` is this one; another, e.g. ``git archive <rev>
kubeflow_tpu_torch | tar -x -C ab_trees/<name>``, in a directory that
``.gitignore`` lists). For each serving configuration, one worker process
per DIR imports that DIR's package (its kernels built from its own
sources into its own ``_build``), builds the llama3-8b engine from seed 0,
fills every slot with a 100-token prompt and runs until the decode graph
is captured. The workers of a configuration live side by side on the
card; this process then has them run decode chunks in turns (DIR
order, then reversed; each chunk between device synchronisations, as the
server steps), and then each profiles one chunk under torch.profiler: device
kernels a step, kernels by name (K7 and its staged mode, K9, K4, K3, copy
kernels) with their device time, busy time and idle share, and the launch
counters the engine keeps over that chunk (graph replays counted).

Configurations (what ``chip_smoke.py`` serves): ``bf16``, ``int8_kv``,
``int8_weights`` and ``fused_int8`` (fused q/k/v and gate/up, int8
weights): 8 slots, max_len 1024, staged chunks of 8; ``paged`` (int8
weights and KV, a pool of 816 16-row blocks) and ``paged_dense`` (the same
over the dense cache): 48 slots, max_len 512, staged chunks of 32.

Prints the card's name and power limit first, one line a configuration
and DIR, and a JSON line of everything last. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CONFIGS = ("bf16", "int8_kv", "int8_weights", "fused_int8", "paged",
           "paged_dense")
#: Kernel families read by name in the profiled chunk.
FAMILIES = {"K7": "::rope_kernel", "K7 staged": "::rope_stage_kernel",
            "K9": "::swiglu_fwd", "K4": "int8_linear", "K3": "decode_attn",
            "copy": "copy"}
PAGED_BLOCKS, PAGED_BS = 816, 16


def _engine(name: str):
    """The llama3-8b engine of configuration ``name``, weights from seed 0."""
    import torch

    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    paged = name.startswith("paged")
    chunk = 32 if paged else 8
    model_kw = dict(param_dtype="bfloat16", decode_staging=chunk,
                    scan_layers=False, remat=False)
    serve_kw = dict(max_batch=48 if paged else 8,
                    max_len=512 if paged else 1024, decode_chunk=chunk,
                    param_dtype="bfloat16")
    if name == "int8_kv" or paged:
        model_kw["kv_cache_dtype"] = "int8"
    if name in ("int8_weights", "fused_int8") or paged:
        serve_kw["quantize"] = "int8"
    if name == "fused_int8":
        model_kw.update(fused_qkv=True, fused_gate_up=True)
    if paged:
        model_kw["max_seq_len"] = 512
        serve_kw["prefill_buckets"] = (128,)
        serve_kw.update(kv_blocks=PAGED_BLOCKS, kv_block_size=PAGED_BS)
        if name == "paged":
            model_kw.update(paged_kv_blocks=PAGED_BLOCKS,
                            paged_kv_block_size=PAGED_BS)
    with torch.device("cuda"):
        model = Llama(LlamaConfig.llama3_8b(**model_kw))
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return ServingEngine(model, ServingConfig(**serve_kw), device="cuda",
                         registry=MetricsRegistry())


def _counters():
    from kubeflow_tpu_torch.serving import engine as eng

    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in eng._LAUNCH_COUNTERS}


def _profile(engine) -> dict:
    """One decode chunk under torch.profiler (between synchronisations)."""
    import torch

    steps = engine.cfg.decode_chunk
    before = _counters()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = {k: v - before.get(k, 0) for k, v in _counters().items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    out = dict(wall_ms=wall, busy_ms=busy,
               idle=1 - busy / wall if busy > 0 else None,
               kernels_a_step=sum(e.count for e in kernels) / steps,
               counters_a_step={k: v / steps for k, v in counts.items()})
    for fam, pat in FAMILIES.items():
        own = [e for e in kernels if pat in e.key.lower()
               or pat in e.key]
        out[fam] = dict(a_step=sum(e.count for e in own) / steps,
                        us_a_step=sum(e.device_time_total for e in own)
                        / steps)
    out["copies"] = [(e.key[:90], e.count / steps,
                      e.device_time_total / steps) for e in kernels
                     if "copy" in e.key.lower()]
    out["top"] = [(e.key[:70], e.count / steps,
                   e.device_time_total / steps)
                  for e in sorted(kernels,
                                  key=lambda e: -e.device_time_total)[:10]]
    return out


def worker(tree: str, name: str) -> int:
    """Serve commands on stdin ("chunk", "profile", "quit") with one JSON
    line each on stdout, for the engine ``name`` of ``tree``'s package."""
    sys.path.insert(0, os.path.abspath(tree))
    # Replies go to the coordinating process on the real stdout; anything
    # else printed (the package, torch, CUDA) goes to stderr.
    reply = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    import numpy as np
    import torch

    def send(obj):
        print(json.dumps(obj), file=reply, flush=True)

    t0 = time.time()
    engine = _engine(name)
    chunk = engine.cfg.decode_chunk
    rs = np.random.RandomState(0)
    for _ in range(engine.cfg.max_batch):
        engine.submit(rs.randint(0, 128256, 100).tolist(),
                      max_new_tokens=chunk * 12)
    engine.step()                   # admission, prefill, the first chunk
    engine.step()                   # the decode graph is captured
    torch.cuda.synchronize()
    send({"ready_s": time.time() - t0})
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "chunk":
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.step()           # one chunk, ends in the host fetch
            ms = (time.perf_counter() - t) * 1e3 / chunk
            send({"ms": ms})
        elif cmd == "profile":
            send(_profile(engine))
        else:
            break
    return 0


def _ask(proc, cmd: str) -> dict:
    proc.stdin.write(cmd + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"worker exited (rc {proc.wait()})")
    return json.loads(line)


def run_config(name: str, trees: list, rounds: int) -> dict:
    procs = {tree: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", tree,
         "--config", name], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True) for tree in trees}
    try:
        ready = {}
        for tree, proc in procs.items():
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"{name} {tree}: worker exited (rc "
                                   f"{proc.wait()})")
            ready[tree] = json.loads(line)["ready_s"]
        times = {tree: [] for tree in trees}
        for r in range(rounds):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                times[tree].append(_ask(procs[tree], "chunk")["ms"])
        prof = {tree: _ask(procs[tree], "profile") for tree in trees}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    proc.stdin.write("quit\n")
                    proc.stdin.flush()
                except OSError:
                    pass
            proc.wait(timeout=120)
    out = {}
    for tree in trees:
        p = prof[tree]
        out[tree] = dict(ready_s=ready[tree], ms=times[tree],
                         median_ms=statistics.median(times[tree]),
                         least_ms=min(times[tree]), **p)
        fam = "; ".join(f"{k} {p[k]['a_step']:.1f} a step, "
                        f"{p[k]['us_a_step']:.2f} us" for k in FAMILIES)
        print(f"{name} [{tree}]: decode ms a step median "
              f"{out[tree]['median_ms']:.4f} / least "
              f"{out[tree]['least_ms']:.4f} ({rounds} chunks in turns); "
              f"profiled chunk wall {p['wall_ms']:.2f} ms, busy "
              f"{p['busy_ms']:.2f}, idle share "
              + ("not measured" if p["idle"] is None else f"{p['idle']:.4f}")
              + f"; device kernels a step {p['kernels_a_step']:.1f}; {fam}; "
              f"counters a step {p['counters_a_step']}", flush=True)
        for key, count, us in p["copies"]:
            print(f"    copy {key}: {count:.2f} a step, {us:.2f} us",
                  flush=True)
        for key, count, us in p["top"]:
            print(f"    top {key}: {count:.2f} a step, {us:.2f} us",
                  flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--worker", default=None)
    ap.add_argument("--config", default=None)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.config)
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    results = {}
    for name in args.configs.split(","):
        if name not in CONFIGS:
            raise SystemExit(f"unknown configuration {name!r} (of "
                             f"{', '.join(CONFIGS)})")
        results[name] = run_config(name, args.dirs or ["."], args.rounds)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and no result line is printed):

1. device — CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build — compiles the flash-attention kernel from
   kubeflow_tpu_torch/ops/csrc with nvcc (sm_90a) and prints the seconds
   and the register/spill report;
3. kernel — holds the kernel against its plain PyTorch version at the
   serving shapes (bf16, H=32, Hkv=8, D=128; causal B=8 at Sq=Skv 32, 128
   and 512; one full-attention case; one D=64 case; one flash_attention_lse
   case whose offset masks rows fully). o within atol = rtol = 2e-2, lse
   within 1e-2, masked rows exactly 0 and -1e30. Times, on the device
   (CUDA-graph replays), the kernel, the plain version and, as a yardstick
   the port never calls, torch.nn.functional.scaled_dot_product_attention;
   also the kernel's eager call time, host overhead included; and
   computes the card's least time for the same work;
4. serve — builds the llama3-8b server from the KFTPU_SERVING_* env
   (full width, random bf16 weights made on the card) and sends 9
   concurrent /v1/generate requests over HTTP across the prefill buckets,
   one past the largest (chunked prefill), one streamed and one sampled.
   Checks the token counts and ids, that the flash kernel ran once per
   layer per grouped prefill (its launch count is zeroed just before),
   and re-forwards two greedy requests through the model with the plain
   attention in f32 and in bf16, asserting each served token's logit is
   within twice the bf16 re-forward's measured rounding noise of the f32
   max. Prints tok/s, p50 TTFT, weight bytes
   and peak device memory, then profiles one full-batch decode chunk
   (wall time, device busy time, idle share, top device kernels);
5. prints the {"kernels": [...]} line, then the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# The card's published peaks (H100 SXM data sheet, dense): bf16 tensor-core
# rate and memory bandwidth. Times below them are the least possible.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
H, HKV = 32, 8      # llama3-8b's query and kv heads


def log(msg: str) -> None:
    print(msg, flush=True)


def _elapsed_ms(run, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the Python
    and launch overhead of the wrapper does not pace the device. Warmed
    up on a side stream first, as capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return _elapsed_ms(graph.replay, replays) / (calls * replays)


def eager_ms(fn, iters: int = 20) -> float:
    """Time per call issued eagerly (host overhead included when the host
    is slower than the device)."""
    for _ in range(3):
        fn()
    return _elapsed_ms(fn, iters) / iters


def attention_bound_ms(b, sq, skv, h, hkv, d, causal, offset):
    """Least time on this card: the larger of the bytes the function must
    move (q, k, v read once; o and lse written once) over the memory rate,
    and the tensor-core operations the live (q, kv) pairs need over the
    bf16 peak. Dead causal pairs cost no operations."""
    qpos = np.arange(sq)[:, None] + offset
    live = (qpos >= np.arange(skv)[None, :]).sum() if causal else sq * skv
    flops = 4.0 * b * h * d * float(live)
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * skv * hkv * d) + 4 * b * h * sq
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def kernel_phase():
    from kubeflow_tpu_torch.ops.flash_attention import (
        NEG_INF,
        flash_attention,
        flash_attention_lse,
        flash_attention_reference,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    # (name, B, Sq, Skv, d, causal, q_offset, kv_offset)
    cases = [
        ("causal_b8_s32", 8, 32, 32, 128, True, 0, 0),
        ("causal_b8_s128", 8, 128, 128, 128, True, 0, 0),
        ("causal_b8_s512", 8, 512, 512, 128, True, 0, 0),
        ("full_b8_s256", 8, 256, 256, 128, False, 0, 0),
        ("causal_b8_s512_d64", 8, 512, 512, 64, True, 0, 0),
        ("lse_masked_b4_s256", 4, 256, 256, 128, True, 0, 128),
    ]
    rows, max_err = [], 0.0
    for name, b, sq, skv, d, causal, q_off, kv_off in cases:
        q, k, v = rand(b, sq, H, d), rand(b, skv, HKV, d), rand(b, skv, HKV, d)
        off = q_off - kv_off
        scale = d ** -0.5

        def kernel():
            return flash_attention_lse(q, k, v, causal=causal,
                                       q_offset=q_off, kv_offset=kv_off)

        def plain():
            return flash_attention_reference(q, k, v, causal=causal,
                                             scale=scale, offset=off)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qpos = torch.arange(sq, device="cuda")[:, None] + off
        mask = qpos >= torch.arange(skv, device="cuda")[None, :]

        # SDPA's is_causal aligns row 0 with col 0; other offsets need the
        # explicit mask (which keeps SDPA off its flash backend).
        plain_causal = causal and off == 0 and sq == skv
        sdpa_mask = mask if causal and not plain_causal else None

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, is_causal=plain_causal,
                enable_gqa=True)

        with torch.no_grad():
            o, lse = kernel()
            o_ref, lse_ref = plain()
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2,
                                       rtol=2e-2)
            torch.testing.assert_close(lse, lse_ref, atol=1e-2, rtol=0)
            if off < 0:
                dead = -off          # q rows that see no kv column
                if not (torch.all(o[:, :dead] == 0)
                        and torch.all(lse[:, :, :dead] == NEG_INF)):
                    raise AssertionError(f"{name}: masked rows not 0/-1e30")
            ms = device_ms(kernel)
            call_ms = eager_ms(kernel)
            plain_ms = device_ms(plain)
            library_ms = device_ms(library)
        bound, bound_by = attention_bound_ms(b, sq, skv, H, HKV, d, causal,
                                             off)
        max_err = max(max_err, err)
        row = dict(case=name, max_abs_err=err, lse_err=lse_err, ms=ms,
                   call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        log(f"kernel {name}: err {err:.3e} lse_err {lse_err:.3e} kernel "
            f"{ms:.4f} ms (eager call {call_ms:.4f} ms) plain "
            f"{plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
            f"{bound * 1e3:.2f} us ({bound_by})")
    return rows, max_err


def post(base: str, body: dict):
    req = urllib.request.Request(
        f"{base}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if body.get("stream"):
            chunks = [json.loads(line) for line in r]
            toks = [t for c in chunks[:-1] for t in c["tokens"]]
            return {"tokens": toks, **chunks[-1]}
        return json.load(r)


def serve_phase():
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serving.server import build_server, env_config

    os.environ.update({
        "KFTPU_SERVING_MODEL": "llama3-8b", "KFTPU_SERVING_MAX_BATCH": "8",
        "KFTPU_SERVING_MAX_LEN": "1024", "KFTPU_SERVING_DECODE_CHUNK": "8",
        "KFTPU_SERVING_HOST": "127.0.0.1", "KFTPU_SERVING_PORT": "0",
    })
    os.environ.pop("KFTPU_PLATFORM", None)          # cuda
    t0 = time.time()
    server = build_server(env_config())
    engine = server.engine
    model = engine.model
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log(f"serve: llama3-8b built in {time.time() - t0:.1f} s, weights "
        f"{weight_bytes / 1e9:.2f} GB")
    engine.warmup(512)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    V = model.cfg.vocab_size
    rs = np.random.RandomState(0)
    new = 32
    specs = [(20, {}), (30, {}), (100, {}),
             (120, {"temperature": 0.8, "top_k": 40, "top_p": 0.95}),
             (200, {"stream": True}), (250, {}), (400, {}), (500, {}),
             (700, {})]                                 # 700 > bucket 512
    bodies = [{"tokens": rs.randint(0, V, n).tolist(), "max_new_tokens": new,
               **extra} for n, extra in specs]
    outs = [None] * len(bodies)
    errors = []

    def client(i):
        try:
            outs[i] = post(base, bodies[i])
        except Exception as e:  # noqa: BLE001 — reported below, then fail
            errors.append(f"request {i}: {e!r}")

    try:
        torch.cuda.reset_peak_memory_stats()
        flash_attention.fwd_launches = 0
        engine.prefill_dispatches = 0
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.time() - t0
        launches = flash_attention.fwd_launches
        dispatches = engine.prefill_dispatches
        peak = torch.cuda.max_memory_allocated()      # the burst's own
    finally:
        server.stop()
    if errors or any(o is None for o in outs):
        raise RuntimeError(f"serve failed: {errors}")
    for body, out in zip(bodies, outs):
        toks = out["tokens"]
        if len(toks) != new or not all(0 <= t < V for t in toks):
            raise AssertionError(f"bad tokens for a {len(body['tokens'])}-"
                                 f"token prompt: {toks}")
    layers = model.cfg.num_layers
    if dispatches < 1 or launches != layers * dispatches:
        raise AssertionError(f"flash launches {launches} != {layers} x "
                             f"{dispatches} prefill dispatches")
    gaps, bounds = greedy_check(model, [bodies[2], bodies[6]],
                                [outs[2], outs[6]])
    decode_breakdown(engine, rs)
    generated = sum(len(o["tokens"]) for o in outs)
    ttft_p50 = float(np.median([o["ttft_s"] for o in outs]))
    log(f"serve: {len(outs)} requests, {generated} tokens in {wall:.2f} s "
        f"= {generated / wall:.1f} tok/s, p50 TTFT {ttft_p50 * 1e3:.1f} ms, "
        f"{dispatches} prefill dispatches, flash launches {launches}, "
        f"weights {weight_bytes / 1e9:.2f} GB, peak device memory "
        f"{peak / 1e9:.2f} GB; greedy f32 re-forward: {len(gaps)} tokens, "
        f"{sum(g == 0 for g in gaps)} exact, max gap {max(gaps):.4f}, "
        f"bounds (2 x bf16 noise) {min(bounds):.4f}-{max(bounds):.4f}")
    return launches


def decode_breakdown(engine, rs):
    """One decode chunk (decode_chunk steps for every slot, all slots
    busy) under torch.profiler: wall time, device busy time (the sum of
    the device kernels' own times) and the device's idle share."""
    V = engine.model.cfg.vocab_size
    for _ in range(engine.cfg.max_batch):
        engine.submit(rs.randint(0, V, 100).tolist(), max_new_tokens=64)
    engine.step()                       # admit + prefill + first chunk
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side kernel events only (the CPU ops that launched them carry
    # the same time again); one stream, so their sum is the busy time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    steps = engine.cfg.decode_chunk
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:6]
    log(f"decode chunk: {steps} steps x {engine.cfg.max_batch} slots, wall "
        f"{wall_ms:.2f} ms ({wall_ms / steps:.2f} ms/step), device busy "
        + (f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}"
           if busy_ms > 0 else "not measured (no device events)"))
    for e in top:
        log(f"  {e.key[:70]}: {e.device_time_total / 1e3:.2f} ms over "
            f"{e.count} calls")
    while engine.active_slots:
        engine.step()


def greedy_check(model, bodies, outs):
    """Re-forward each served greedy request's own sequence with the plain
    attention (attn_impl="full") twice on the same bf16 weights: in f32
    activations, the reference, and in bf16, as the engine computes. At
    each step the bf16 re-forward's largest logit error against the f32
    one, m, is the rounding noise a bf16 forward of this model carries at
    this depth, measured in this run. The engine's logits carry noise of
    that size, so its argmax a can fall below the f32 argmax b by at most
    |noise(a)| + |noise(b)| <= 2m: every served token must lie within 2m
    of the f32 max. (A fixed count of bf16 ulps is no bound: at 32 layers
    the noise sets it, and the served runs differ in batching, so in
    rounding, from call to call.) A state bug (wrong cache row, position
    or mask) picks tokens whole logit-gaps below the max, several logit
    standard deviations at a 128k vocabulary; at least half the served
    tokens must also BE the f32 argmax. Positions are the engine's:
    prompt 0..L-1, then generated token i at L + 1 + i (the JAX engine's
    decode RoPE positions, which the port follows), so one causal forward
    of prompt + served tokens gives every step's logits from row L - 1
    on. Returns the gaps and the bounds."""
    import dataclasses

    from kubeflow_tpu_torch.models.llama import Llama

    # The f32-activation model shares the served model's bf16 parameters
    # (meta construction, then assign): Dense casts them at each product.
    with torch.device("meta"):
        model32 = Llama(dataclasses.replace(model.cfg, dtype=torch.float32))
    model32.load_state_dict(model.state_dict(), assign=True)
    dev = model.embed.device
    gaps, bounds, exact = [], [], 0
    with torch.no_grad():
        for body, out in zip(bodies, outs):
            prompt, gen = body["tokens"], out["tokens"]
            L = len(prompt)
            tokens = torch.tensor([prompt + gen[:-1]], device=dev)
            pos = torch.tensor([list(range(L)) + [L + 1 + j for j in
                                                  range(len(gen) - 1)]],
                               device=dev)

            def step_logits(m):
                h = m(tokens, positions=pos, attn_impl="full",
                      return_hidden=True)[:, L - 1:]
                return m.head_logits(h)[0].float()          # [len(gen), V]

            ref = step_logits(model32)
            noise = (step_logits(model) - ref).abs().amax(-1)
            top, arg = ref.max(-1)
            served = torch.tensor(gen, device=dev)
            gap = top - ref.gather(1, served[:, None])[:, 0]
            exact += int((arg == served).sum())
            for i, (g, m) in enumerate(zip(gap.tolist(), noise.tolist())):
                gaps.append(g)
                bounds.append(2 * m)
                if g > 2 * m:
                    raise AssertionError(
                        f"served token {gen[i]} at step {i} is {g:.4f} below "
                        f"the f32 re-forward max {top[i].item():.4f} (bound "
                        f"2 x bf16 noise {m:.4f} = {2 * m:.4f})")
    if exact < 0.5 * len(gaps):
        raise AssertionError(f"only {exact} of {len(gaps)} served greedy "
                             "tokens are the f32 re-forward's argmax")
    return gaps, bounds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from kubeflow_tpu_torch.ops import _build

    t0 = time.time()
    lib = _build.build("flash_attention_fwd.cu")
    log(f"build: flash_attention_fwd.cu in {time.time() - t0:.1f} s")
    with open(lib[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

    rows, max_err = kernel_phase()
    launches = serve_phase()
    main_row = next(r for r in rows if r["case"] == "causal_b8_s512")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:115",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

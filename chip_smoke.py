"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero, and no result line is printed):

1. device — CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build — compiles the flash-attention kernels (K1, K2), the decode
   attention (K3), the int8-weight product (K4), the optimizer (K5),
   RMSNorm and the residual add + RMSNorm (K6, K10: one source), RoPE
   (K7), the cross-entropy (K8), SwiGLU (K9), the adafactor update
   (K11) and the MoE routing, gather and combine (K12-K14: one source)
   from kubeflow_tpu_torch/ops/csrc with nvcc (sm_90a), one nvcc per
   source, and the native token loader (kubeflow_tpu_torch/train/csrc,
   g++, into kubeflow_tpu_torch/_build/native), all started together, and
   prints the seconds and each register/spill report; then checks the
   SASS: every bf16 instantiation of K1's kernel
   and of K2's dk/dv and dq kernels holds wgmma (HGMMA) and TMA loads
   (UTMALDG), every one of K3's 32 (D 64/128, G 1/2/4/8, bf16/int8 cache,
   dense/paged) TMA loads and mma.sync (HMMA), every one of K4's 6 decode
   ones (8 or 16 tokens; per-row or per-column scales, and the SwiGLU
   epilogue's two) mma.sync and cp.async (LDGSTS),
   every one of its 6 prefill ones (64, 128 or 256 tokens a tile; per-row
   or per-column scales) wgmma and TMA loads, and ptxas reports no spills
   in any of the eleven libraries;
3. kernel (K1, forward) — holds the kernel against its plain PyTorch
   version at the serving shapes (bf16, H=32, Hkv=8, D=128; causal B=8 at
   Sq=Skv 32, 128 and 512; one full-attention case; one D=64 case; one
   flash_attention_lse case whose offset masks rows fully), at the
   chunked-prefill extend's (one slot: Sq=512 over Skv=1024 from q
   offsets 0 and 188, Sq=128 over Skv=512 from 172; the offset a device
   tensor) and at the training forward's (B=12, S=2048, H=16, Hkv=8,
   causal). o within
   atol = rtol = 2e-2, lse within 1e-2, masked rows exactly 0 and -1e30.
   Times, on the device (CUDA-graph replays), the kernel, the plain version
   and, as a yardstick the port never calls,
   torch.nn.functional.scaled_dot_product_attention; also the kernel's
   eager call time, host overhead included (best of three runs of 20
   calls), and the host time of its C entry alone (tensor maps and
   launch); and computes the card's least time for the same work; times
   what the extend runs in front of K1 with an int8 cache, one layer's K
   and V: the paged gather of a slot's 32 pages and the dequantization
   to bf16, and the dense cache's dequantization of a 1024-row slot;
4. kernel (K2, backward) — holds the kernel against its plain version
   (flash_attention_backward_reference) on the same inputs at the training
   shape (bf16, B=12, S=2048, H=16, Hkv=8, D=128, causal), bf16 S=512 at
   D=64 and D=128, one full-attention case, one ragged case (S=1000), one
   flash_attention_lse case whose offset masks rows fully with a non-zero
   lse cotangent, and one f32 case: each of dq/dk/dv within
   2e-2 x max|plain| (bf16; 1e-4 in f32), masked rows' grads exactly 0.
   Times the kernel (CUDA-graph replays, and the eager autograd backward),
   the plain version and, as a yardstick, the backward of
   scaled_dot_product_attention(enable_gqa=True) (grads of a retained
   graph, captured the same way), beside the bound
   max(bytes / 3.35 TB/s, 10 B H live D / 989 TFLOP/s) and the bound of
   K2's seven-product split (14 B H live D); at the train shape also the
   device ms of K2's dk/dv and dq kernels apart (torch.profiler, by
   kernel name);
5. kernel (K3, decode attention) — holds the kernel against its plain
   version (decode_attention_reference) at the decode shape (bf16 q, B=8,
   H=32, Hkv=8, D=128, L=1024, the burst's ragged live lengths) over the
   bf16 and the int8 cache, unstaged and staged (8 staging rows, all
   live), and at the long context (L=8192, live rows 1024-8192, staged,
   both caches): max |kernel - plain| <= 2e-2 x max |plain|, two calls
   bitwise equal. Times, on the device (CUDA-graph replays), the kernel
   cold (consecutive calls on different cache sets whose live rows
   exceed twice the L2, as the served step reads each layer's cache) and
   warm (one set), the plain version and, for the unstaged bf16 case,
   scaled_dot_product_attention(enable_gqa=True) with a bool mask over
   the cache, cold and warm, as a yardstick the port never calls;
   computes the bound (bytes of the live rows, q and o over 3.35 TB/s);
   then K3 by block table at the paged serve phase's decode shape (B=48,
   max_len 512 in 16-row pages, live rows 128-255, 32 staging rows, bf16
   and int8 pools, the table a random permutation of the pool's pages):
   against paged_decode_attention (gather, then the plain version) within
   2e-2 x max |plain|, bitwise against K3's dense call over the gathered
   rows, and timed cold beside that dense call, in turns;
6. kernel (K4, int8-weight product) — holds the kernel against its plain
   version (int8_linear_reference: the weight dequantized to bf16, then
   F.linear, which sums in f32 as K4 does) at llama3-8b's seven
   projections and lm_head at M = 8 (the decode step's; o_proj with its
   per-head-dim scales), at the gate shape for M = 1, 9, 64, 512, 1024 and
   4096, at the grouped launches of q/k/v and gate/up at M = 8, and at
   each launch a layer makes (the q/k/v and gate/up groups, o, down) at
   the paged path's M = 32, 48 (its decode batch) and 128 (its extend
   chunk), each product against its plain version: max |kernel - plain|
   <= 1e-2 x
   max |plain|, two calls bitwise equal. Times, on the device (CUDA-graph
   replays), the kernel cold (consecutive calls rotating over weight sets
   larger than twice the L2, as the served step reads each layer's
   weights once) and warm, the plain version and, as the yardstick the
   port never calls, F.linear on the weight dequantized beforehand (bf16:
   twice the bytes; a group's weights concatenated), cold and warm; at
   M <= 16 also each split of K over a cluster (1, 2, 4, 8 blocks); the
   bound max(bytes / 3.35 TB/s, 2 M N K / 989 TFLOP/s), and the sum over
   a decode step's products, launched apart (225) and grouped (129); then
   the SwiGLU epilogue at M = 8 (gate/up as two weights and as the fused
   [2F, K] one): bitwise the grouped K4 followed by K9 at each split,
   within the tolerance of the plain version, timed cold beside the
   grouped K4 alone and the group then K9, in the same call;
7. kernel (K5-K10, the element-wise work of the step and the serving
   forward) — holds
   each against its plain version on the same inputs: K6 (RMSNorm) at
   the train step's [24564, 2048] bf16, forward and backward, and at
   llama3-8b's serving rows [8, 4096] and [4096, 4096], forward; K7 (RoPE
   of q and k in one launch) at the train step's q [12, 2047, 16, 128], k
   [12, 2047, 8, 128], forward and backward, and at serving's [8, 1, 32/8,
   128], [48, 1, 32/8, 128] and [1, 512, 32/8, 128]: within one bf16 ulp
   (an element below
   2^-8 of the largest compared at that scale) and two calls bitwise
   equal; K8 (the cross-entropy) at [24564, 32000] bf16 logits with the
   trainer's z-loss: the loss within relative 1e-5, dlogits within 2e-2 x
   max |plain|, the hits equal, two calls bitwise equal; K5 (the
   optimizer) over the 700M model's 111 tensors (bf16 params, grads and
   mu, f32 nu): the norm within relative 1e-6 of an f64 sum and two calls
   bitwise equal, the update bitwise the plain update given the same norm,
   clipped and not. Times each (CUDA-graph replays; cold over sets larger
   than twice the L2 where a call is smaller), its plain version and the
   library call the port never makes (F.rms_norm, F.cross_entropy without
   z-loss, torch.optim.AdamW(fused=True) timed eagerly; none for RoPE),
   beside the byte bound; then K7's strided mode (q and k read in place
   from the fused q/k/v projection, dq and dk written into the fused
   gradient's slots) at the fused train step's [12, 2047, 8, 2 + 2, 128]
   (and v's copy into the tensor K1 reads) and serving's [8, 1, 8, 4 + 2,
   128], [48, 1, 8, 4 + 2, 128] and [1, 512, 8, 4 + 2, 128], bitwise;
   K7's staged-decode mode (q rotated, k rotated into a staging column, v
   copied into it, one launch) at [8, 1, 32/8/8, 128] over 8 staging rows
   and [48, ...] over 32, q/k/v apart and fused, bitwise with the staging
   tensors compared whole, timed beside K7 then the two copies it
   replaces; K9 (SwiGLU) with gate and
   up apart and as the halves of the fused [rows, 2, F] product at the
   train step's [24564, 5632] (forward and backward) and serving's [8,
   14336], [48, 14336] and [512, 14336], bitwise; K10 (the residual add + RMSNorm) at
   [24564, 2048] (forward and backward, with the residual's gradient) and
   [8, 4096], [48, 4096], [4096, 4096]: the sum bitwise, y, dx and dw
   within one bf16 ulp; each timed beside its byte bound, no library
   call; at 8 and 48 rows (and K6 at 8) through the rows kernel (a
   thread a 16-byte chunk, the weight loaded with x; ops/norms.py's
   ROWS_MAX), timed a launch beside the block-a-row kernel;
7b. kernel (K11, the adafactor update with the global norm folded in) —
   over the 700M model's 111 tensors at their real shapes (bf16 params
   and grads, the JAX leaves stacked over the 12 layers, f32 moments of
   earlier steps), against its plain version on the same inputs, clipped
   and not: params within one bf16 ulp of it, moments within 1e-6
   relative of it computed in f64, two calls bitwise equal, the norm it
   computes within 1e-6 relative of K5's global_norm.
   Times K11 (CUDA-graph replays; its seven kernels apart from a profiled
   pass, each tile pass beside its own bytes; the bytes of g in flight an
   SM in its g-only pass), beside PR 14's 4.54 ms of K5's norm and K11,
   the plain version and torch.optim.Adafactor's step on the same tensors
   (eager; a yardstick the port never calls, and not the same function:
   its own eps, clip and relative step), beside the byte bound (g read, p
   read and written once: 6 bytes a parameter);
7c. kernel (K12-K14, the MoE dispatch) — the routing, the row gather
   into the expert buffers and the weighted combine against their plain
   versions (ops/moe.py) at mixtral-8x7b's decode step (8 rows, 8
   experts, capacity 4, width 4096, bf16) and a prefill group (4096 rows,
   capacity 1280), logits with a hot expert so that capacity drops
   choices: K12's integer outputs equal and its weights and aux bitwise,
   K13 and K14 bitwise, two calls bitwise equal; each timed (CUDA-graph
   replays, cold over sets past twice the L2 where a call is smaller)
   beside its plain version and its byte bound; no library call;
8. serve — builds the llama3-8b server from the KFTPU_SERVING_* env
   (full width, random bf16 weights made on the card; staged decode and
   CUDA graphs, as the server runs by default) and sends 9 concurrent
   /v1/generate requests over HTTP across the prefill buckets, one past
   the largest (chunked prefill), one streamed and one sampled, twice:
   the cold burst captures the graphs its new shapes need, the warm one
   finds them; then all again with KFTPU_SERVING_QUANTIZE_KV=int8, and
   again with KFTPU_SERVING_QUANTIZE=int8 (int8 weights, bf16 KV cache).
   Each server warms with a 700-token prompt length, so warmup also
   captures the chunked-prefill extend's greedy graph. The bf16 server
   also loads a WordLevel tokenizer built here (KFTPU_SERVING_TOKENIZER;
   where the tokenizers package imports, else it says so) and serves a
   text request, plain and streamed. Checks the token counts and
   ids, that K1 ran once per layer per grouped prefill or chunked-prefill
   chunk, K3 once per layer per decode step and K4 once per group the
   model forms (q/k/v, gate/up) and per other int8 projection (4 a layer
   and the lm_head: 129) per decode step and per grouped prefill or
   extend (launch counts zeroed just before the burst, graph replays
   counted; per decode step, prefill and extend chunk: K6 once (the
   first layer's input norm), K7 and SwiGLU once a layer, K10 twice a
   layer: after the attention and into the next norm; every decode step
   K7 in its staged mode, which writes the staging rows; SwiGLU as K9, or
   at the int8-weight burst's decode steps as K4's epilogue, no K9), and
   re-forwards two
   greedy
   requests through the model with the plain attention in f32 and in
   bf16 (for the int8 KV burst with the decode rows' k/v quantized and
   dequantized, as the cache holds them; for the int8-weight burst on the
   dequantized bf16 weights), asserting each served token's
   logit is within twice the bf16 re-forward's measured rounding noise of
   the f32 max. Prints tok/s, p50 TTFT (and the 700-token request's),
   weight bytes and peak device memory (and the build's peak); times the
   extend's 512-token chunk eager against graphed (each chunk between
   device synchronisations, median of 7, warm and after an L2 flush);
   then profiles one full-batch decode
   chunk (wall time, device busy time, idle share, top device kernels,
   K6's and K10's rows kernels by name and counter, once a step and twice
   a layer a step, with their time a launch, K7's staged kernel once a
   layer a step and no plain K7, K9 none with int8 weights (the
   epilogue), fewer copy kernels than the two staging writes a layer a
   step would make, and the device kernels a step,
   K3's kernel launches, which must be one per layer per step: 256, and
   with int8 weights K4's: 129 a step, 1032) and times three more without
   the profiler;
9. serve paged — builds llama3-8b as ``bench.py serving8b --paged`` does
   (int8 weights, int8 KV cache, staged decode in chunks of 32, 48 slots,
   max_len 512, a pool of 816 16-row blocks) and the same engine over the
   dense cache, each from seed 0, and runs through each ``run()`` burst
   (a), 96 random 128-token prompts (seed 0) with 128 new tokens, greedy,
   and burst (b), the same with one 64-token head (shared pages) and four
   pairs of identical 120-token prompts (a shared partial page, forked at
   the first decode write), and burst (c), 8 prompts of 300 tokens (three
   128-token extend chunks each, the last slid back; request 5 shares
   request 4's 160-token head, so its chunks write from 160 on) with 32
   new tokens. Each engine warms with a 300-token length (the extend's
   greedy graph). Checks every request's tokens against the
   dense engine's (burst (b) may differ only for requests that reuse
   another prefill group's rows, and only where this run shows a prompt's
   rows from prefill groups of 1 and 48 not bitwise equal; burst (c)
   none), the launch counts of K1, K3 and K4 (zeroed just before each
   burst; K1 and K4 once per prefill and per extend chunk; K6, K7, K9 and
   K10 as in the serve phase), shared
   references and forks in (b), conservation after each drain and a pool
   smaller than the dense cache; prints tok/s, p50 TTFT, peak memory,
   both caches' bytes, the extend's 128-token chunk eager against
   graphed and a profiled full-batch decode chunk (ms a step, idle
   share);
10. serve fused int8 weights — llama3-8b with fused_qkv and
   fused_gate_up and int8 weights (8 slots, chunk 8, staged decode and
   CUDA graphs) and the unfused int8-weight engine on the same random
   weights (the fused rows the unfused ones interleaved), each warmed with
   a 700-token length and driven through the engine: a greedy burst of 9
   requests (prompts 20-700 tokens) with 32 new tokens, the tokens
   compared (where one differs, both sides must be the f32 re-forward's
   argmax within the bf16 noise), K1, K3, K4 (129 a pass: one product
   each for q/k/v and gate/up), K6, K7, K9 and K10 launches checked; a
   profiled decode chunk and decode ms a step for each;
10b. serve mixtral — mixtral-8x7b at full published width (4096, 32/8
   heads of 128, 8 experts of 14336, vocab 32000, rope_theta 1e6) cut to
   16 of its 32 layers (its bf16 weights, 46.97 GB, fit the card; 32
   layers would not), random bf16 weights made on the card from seed 0,
   through the engine (8 slots, max_len 1024, chunk 8, staged decode,
   CUDA graphs, bf16 KV cache), warmed with a 700-token length: a greedy
   burst of 9 requests (20-700 tokens, one through the chunked extend),
   32 new tokens each. Checks the token counts, K1, K3, K6, K7, K9 and
   K10 as the Llama bursts and K12-K14 once a layer a decode step,
   prefill group and extend chunk (graph replays counted); replays one
   served decode step eagerly from a copy of its inputs, cache and
   staging rows: each layer's MoE output bitwise with K12-K14 swapped for
   their plain versions on the same layer input, the swapped replay's
   greedy tokens equal to the served ones; prints decode ms a step
   beside the byte bound of its weights (13.94 ms), tok/s, peak memory,
   weight bytes, a profiled decode chunk (K12-K14 by kernel name, once a
   layer a step) and the phase's seconds;
11. train — runs the training runner in-process (the KFTPU_* env) on the
   ~700M-parameter Llama of ``bench.py train`` at full width and depth
   (vocab 32000, embed 2048, 12 layers, 16/8 heads, head_dim 128, MLP
   5632; batch 12 x seq 2048; bf16 params, bf16 Adam mu, bf16 logits;
   remat "qkv_attn"; flash attention) for 10 steps with a checkpoint every
   5, then again to 12 steps, which resumes from step 10. Checks the loss
   is finite and falls, that K2 ran once per layer per step and K1 twice
   (the forward, and its replay for lse in the backward under
   "qkv_attn"), and K5-K10 as train_launches_per_step says (K6 25 forward
   and 13 backward a step, K7 24 and 12, K9 and K10 24 and 12 each, K8
   and K5's norm and update one each), counts zeroed just before each run
   and read just after;
   prints tokens/s, MFU, median synchronised step ms, peak device memory
   and one profiled step, its device ms by profiler range (forward, loss,
   backward, grad_norm, optimizer), by autograd node and by op, and each
   port kernel's share. Then one step's grads of a 2-layer model of the
   same width with attn_impl="flash" against attn_impl="full": each
   parameter's relative error ||g_flash - g_full|| / ||g_full|| within
   GRAD_REL_BOUND;
12. train fused/policies — the same model with fused_qkv and
   fused_gate_up under each of the seven remat policies, each through the
   runner (KFTPU_MODEL_KW) from seed 0 for 4 steps: step 1's loss and
   gradient norm equal "full"'s, bitwise; every step's launches of K1,
   K2 and K5-K10 as train_launches_per_step derives them for the policy;
   prints the median of steps 2-4, MFU and the peak device memory;
12b. train adafactor — the train phase's model (scanned leaves, remat
   "qkv_attn") through the runner with KFTPU_LOADER=native,
   KFTPU_DATA_PATH and KFTPU_EVAL_DATA_PATH naming int32 corpora written
   from a seed (4M and 0.5M tokens in the vocabulary) and
   KFTPU_HPARAMS {"optimizer": "adafactor"}, 6 steps and one eval: every
   step's loss finite and its launches (K11 once, which computes the
   gradients' norm itself: no K5 norm and no K5 update; the rest as the
   adamw step's) asserted, the native loader
   feeding the run and the eval, a finite eval loss; prints the median
   synchronised step, MFU, peak memory beside the adamw train phase's,
   the loader's stalls and one profiled step; then 3 loader-fed steps
   under the profiler with no synchronisation between them, each batch
   copied from pageable memory (the runner's copy before) or through the
   runner's pinned DeviceFeed, in turns: the idle share of each;
13. prints each phase's seconds and the total, the {"kernels": [...]}
   line (K1's entry at the serving prefill shape, with its training-shape
   ms, SDPA ms and bound under train_ keys and the extend's shapes and
   the gather in front of it under their case names; K2's at the train
   shape with dkdv_ms, dq_ms and split_bound_ms; K3's at the served path's case,
   bf16 staged, cold, with its warm_ms, the other cases' times and
   SDPA's under unstaged_/int8_ keys and the long context under l8192_
   keys; K4's at the gate shape, M = 8, cold, with its warm time,
   F.linear's as library_ms, the launches of the int8-weight burst and of
   its profiled chunk, the other shapes and the groups under <name>_ keys
   (the SwiGLU epilogue under gateup_swiglu_ and gateup_fused_swiglu_,
   with the group's time and the group then K9's beside it, and its
   launches in the int8-weight burst as swiglu_launches), a decode
   step's sums under step_apart_ and step_grouped_ keys; K3 by
   table under paged_bf16_ and paged_int8_ keys beside the dense call's
   dense_ms, and its launches in the paged burst; K5-K8 at the train
   step's shapes with their launches over the 10-step run, their device ms
   in the profiled step under step_ms, backward times under bwd_, K6 and
   K7 at the serving shapes under decode_ and prefill_ (K7 also paged_),
   K7's strided mode under strided_<case>_, its staged mode under
   stage_<case>_ (with apart_ms: K7 then the two copies) and its staged
   launches in the bf16 and paged bursts and its us a launch in each
   profiled decode chunk; K9 and K10 likewise (K9's launches in the
   int8-weight and paged bursts), K9's fused layout under
   <case>_fused_; K11 over the 700M model's tensors with its launches
   over the adafactor run and its ms in that run's profiled step; K12,
   K13 and K14 at the decode step's shape with the prefill group's under
   prefill_, their launches over the mixtral burst and their kernels and
   ms in its profiled chunk), then the result line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# The card's published peaks (H100 SXM data sheet, dense): bf16 tensor-core
# rate and memory bandwidth. Times below them are the least possible.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
H, HKV = 32, 8      # llama3-8b's query and kv heads
TRAIN_H, TRAIN_HKV = 16, 8      # the 700M training model's heads
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# flash vs full attention, one step's grads of the 2-layer model in bf16:
# each parameter's ||g_flash - g_full|| / ||g_full|| (PERF.md gives the
# prediction this bound was set from).
GRAD_REL_BOUND = 5e-2
TRAIN_MODEL_KW = {
    "vocab_size": 32000, "embed_dim": 2048, "num_layers": 12,
    "num_heads": 16, "num_kv_heads": 8, "head_dim": 128, "mlp_dim": 5632,
    "max_seq_len": 2048, "param_dtype": "bfloat16", "logits_f32": False,
    "scan_layers": True, "remat": True, "remat_policy": "qkv_attn",
}
TRAIN_BATCH, TRAIN_SEQ = 12, 2048


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


def device_ms(fn, calls: int = 10, replays: int = 5, side=None) -> float:
    """Device time of one ``fn`` call: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the Python
    and launch overhead of the wrapper does not pace the device. Warmed
    up on a side stream first, as capture requires; a backward passes the
    stream its forward ran on, so autograd issues it on the capture
    stream."""
    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    return _elapsed_ms(graph.replay, replays) / (calls * replays)


def eager_ms(fn, iters: int = 20, repeats: int = 3) -> float:
    """Time per call issued eagerly (host overhead included when the host
    is slower than the device): the best of ``repeats`` runs of ``iters``
    calls, so that a hiccup of the shared host does not set it."""
    for _ in range(3):
        fn()
    return min(_elapsed_ms(fn, iters) for _ in range(repeats)) / iters


def entry_us(q, k, v, off, causal, scale, n: int = 200) -> float:
    """Host time of one call of K1's C entry alone (tensor maps and
    launch, no Python checks or allocations), best of three runs of ``n``
    calls: the part of the eager call that the kernel's design sets."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, device=q.device)
    off_t = fa._offset_tensor(off, q.device)
    fn = fa._fwd_kernel_fn()
    args = (1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), off_t.data_ptr(), b, h, k.shape[2], sq,
            k.shape[1], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        best = min(best, (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return best * 1e6


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


def check_build(lib: str, families: dict,
                required=("HGMMA", "UTMALDG")) -> None:
    """A kernel library's build is the Hopper design: every instantiation
    of each family (name -> how many the library must hold) has each of
    the ``required`` SASS instructions (wgmma is HGMMA, a TMA load UTMALDG),
    and ptxas reports no spills for any kernel of the library."""
    import re

    from kubeflow_tpu_torch.ops import _build

    cuobjdump = (shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    found = {family: {} for family in families}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        for family in families:
            if family in name:
                found[family][name] = {op: chunk.count(op)
                                       for op in (*required, "UTMASTG")}
    for family, want in families.items():
        got = found[family]
        if len(got) != want or not all(counts[op] for counts in got.values()
                                       for op in required):
            raise AssertionError(
                f"{family} SASS lacks {'/'.join(required)} (want {want} "
                f"instantiations): {got}")
        for name, counts in sorted(got.items()):
            tiles = name.split(family)[1].split("EEEEE")[0]
            log(f"  sass {family}{tiles}: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
    with open(lib[:-3] + ".log") as f:
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", f.read())]
    if any(spills):
        raise AssertionError(f"{os.path.basename(lib)} spills registers: "
                             f"{spills}")


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

    # (name, B, Sq, Skv, d, causal, q_offset, kv_offset, heads, kv heads):
    # the serving shapes, then the training forward's.
    cases = [
        ("causal_b8_s32", 8, 32, 32, 128, True, 0, 0, H, HKV),
        ("causal_b8_s128", 8, 128, 128, 128, True, 0, 0, H, HKV),
        ("causal_b8_s512", 8, 512, 512, 128, True, 0, 0, H, HKV),
        ("full_b8_s256", 8, 256, 256, 128, False, 0, 0, H, HKV),
        ("causal_b8_s512_d64", 8, 512, 512, 64, True, 0, 0, H, HKV),
        ("lse_masked_b4_s256", 4, 256, 256, 128, True, 0, 128, H, HKV),
        ("causal_b12_s2048_h16", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 128,
         True, 0, 0, TRAIN_H, TRAIN_HKV),
        # The chunked-prefill extend's: one slot's 512-token chunks over its
        # 1024-row cache (the 700-token request's chunks start at 0 and
        # 188), and the paged phase's 128-token chunks over 512 gathered
        # rows (a 300-token prompt's last chunk starts at 172); q_offset a
        # device tensor, as the engine passes it.
        ("extend_s512_kv1024_at0", 1, 512, 1024, 128, True, 0, 0, H, HKV),
        ("extend_s512_kv1024_at188", 1, 512, 1024, 128, True, 188, 0, H,
         HKV),
        ("extend_s128_kv512_at172", 1, 128, 512, 128, True, 172, 0, H, HKV),
    ]
    rows, max_err = [], 0.0
    for name, b, sq, skv, d, causal, q_off, kv_off, h, hkv in cases:
        q, k, v = rand(b, sq, h, d), rand(b, skv, hkv, d), rand(b, skv, hkv, d)
        off = q_off - kv_off
        scale = d ** -0.5
        q_at = (torch.tensor([q_off], device="cuda")
                if name.startswith("extend") else q_off)

        def kernel():
            return flash_attention_lse(q, k, v, causal=causal,
                                       q_offset=q_at, kv_offset=kv_off)

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
            big = sq >= 2048
            ms = device_ms(kernel)
            call_ms = eager_ms(kernel)
            host_us = entry_us(q, k, v, off, causal, scale)
            plain_ms = device_ms(plain, calls=2 if big else 10,
                                 replays=2 if big else 5)
            library_ms = device_ms(library)
        bound, bound_by = attention_bound_ms(b, sq, skv, h, hkv, d, causal,
                                             off)
        max_err = max(max_err, err)
        row = dict(case=name, max_abs_err=err, lse_err=lse_err, ms=ms,
                   call_ms=call_ms, entry_us=host_us, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        log(f"kernel {name}: err {err:.3e} lse_err {lse_err:.3e} kernel "
            f"{ms:.4f} ms (eager call {call_ms:.4f} ms, C entry "
            f"{host_us:.2f} us of host time) plain "
            f"{plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
            f"{bound * 1e3:.2f} us ({bound_by})")
        del q, k, v
        torch.cuda.empty_cache()
    return rows + extend_gather_rows(), max_err


def extend_gather_rows():
    """What the extend runs in front of K1 with an int8 KV cache, one
    layer's K and V on the card (CUDA-graph replays): the paged phase's
    gather of one slot's 32 pages (a random choice of the 817) with their
    scales, then the dequantization to bf16 (``gather_cache``, then
    ``Attention._extend_attention``'s), and the dense int8 cache's
    dequantization of one 1024-row slot. Bound: the int8 rows and f32
    scales read once, the bf16 rows written once."""
    from kubeflow_tpu_torch.ops.paged_attention import (
        gather_cache,
        pool_shape,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)

    def int8_rows(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.02

    def dequant(x, s):
        return (x.float() * s).to(torch.bfloat16)

    shape = pool_shape(SP_BLOCKS, SP_BS, HKV, 128)
    ck, cv = int8_rows(shape), int8_rows(shape)
    ks, vs = scales(shape[:3] + (1,)), scales(shape[:3] + (1,))
    table = torch.randperm(SP_BLOCKS, generator=gen, device="cuda")[
        :SP_MAX_LEN // SP_BS][None].int()

    def paged():
        k, v, k_s, v_s = gather_cache(table, SP_BS, ck, cv, ks, vs)
        return dequant(k, k_s), dequant(v, v_s)

    dk, dv = int8_rows((1, 1024, HKV, 128)), int8_rows((1, 1024, HKV, 128))
    dks, dvs = scales((1, 1024, HKV, 1)), scales((1, 1024, HKV, 1))

    def dense():
        return dequant(dk, dks), dequant(dv, dvs)

    rows = []
    for name, fn, n in (("gather_dequant_paged_l512", paged, SP_MAX_LEN),
                        ("dequant_dense_l1024", dense, 1024)):
        with torch.no_grad():
            ms = device_ms(fn)
        nbytes = 2 * n * HKV * (128 + 4 + 2 * 128)
        bound = 1e3 * nbytes / PEAK_BYTES_PER_S
        rows.append(dict(case=name, ms=ms, bound_ms=bound, bound_by="bytes"))
        log(f"kernel {name}: one layer's K and V {ms:.4f} ms (x32 layers "
            f"{32 * ms:.3f} ms a chunk), bound {bound * 1e3:.2f} us (bytes)")
    return rows


def backward_bound_ms(b, sq, skv, h, hkv, d, causal, offset, products=5):
    """Least time of the backward on this card: the larger of the bytes
    it must move (q, o, do, k, v and the f32 lse and delta read once; dq,
    dk, dv written once) over the memory rate, and its products over the
    live (q, kv) pairs, 2 B H live D FLOPs each, over the bf16 peak. The
    function needs five; K2's deterministic split computes s, p and dp in
    both of its kernels, seven (``products=7``: the split's own bound)."""
    qpos = np.arange(sq)[:, None] + offset
    live = (qpos >= np.arange(skv)[None, :]).sum() if causal else sq * skv
    flops = 2.0 * products * b * h * d * float(live)
    nbytes = 2 * (4 * b * sq * h * d + 4 * b * skv * hkv * d) + 8 * b * h * sq
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def kernel_split_ms(fn, names, runs: int = 5) -> dict:
    """Device ms per call of the kernels whose names hold each of
    ``names``, from a short torch.profiler pass over ``runs`` calls of
    ``fn``: the mean event times the events a call (the count over the
    runs, rounded: a session can lose one event, see
    ``kernels_per_call``); None where the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in names:
        own = [e for e in events if name in e.key]
        total = sum(e.device_time_total for e in own)
        count = sum(e.count for e in own)
        out[name] = (total / 1e3 / count * max(1, round(count / runs))
                     if total > 0 else None)
    return out


def backward_phase():
    """K2 against its plain version; returns (rows, max_abs_err)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    # (name, B, Sq, Skv, d, causal, q_offset, kv_offset, dtype, dlse)
    cases = [
        ("train_b12_s2048", 12, 2048, 2048, 128, True, 0, 0,
         torch.bfloat16, False),
        ("causal_b8_s512", 8, 512, 512, 128, True, 0, 0,
         torch.bfloat16, False),
        ("causal_b8_s512_d64", 8, 512, 512, 64, True, 0, 0,
         torch.bfloat16, False),
        ("full_b4_s512", 4, 512, 512, 128, False, 0, 0,
         torch.bfloat16, False),
        ("ragged_b4_s1000", 4, 1000, 1000, 128, True, 0, 0,
         torch.bfloat16, False),
        ("lse_masked_dlse_b4_s256", 4, 256, 256, 128, True, 0, 128,
         torch.bfloat16, True),
        ("f32_b2_s256", 2, 256, 256, 128, True, 0, 0, torch.float32, False),
    ]
    rows, max_err = [], 0.0
    for name, b, sq, skv, d, causal, q_off, kv_off, dtype, with_dlse in cases:
        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rand(b, sq, TRAIN_H, d), rand(b, skv, TRAIN_HKV, d), \
            rand(b, skv, TRAIN_HKV, d)
        do = rand(b, sq, TRAIN_H, d)
        dlse = (torch.randn(b, TRAIN_H, sq, generator=gen, device="cuda")
                if with_dlse else None)
        off = q_off - kv_off
        scale = d ** -0.5
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o, lse = fa.flash_attention_lse(*leaves, causal=causal,
                                        q_offset=q_off, kv_offset=kv_off)
        o_, lse_ = o.detach(), lse.detach()
        delta = fa._delta(o_, do, dlse)
        off_t = fa._offset_tensor(off, q.device)

        def kernel():
            return fa._bwd_kernel(q, k, v, do, lse_, delta, off_t, causal,
                                  scale)

        outs, cots = ((o, lse), (do, dlse)) if with_dlse else ((o,), (do,))

        def eager():
            return torch.autograd.grad(outs, leaves, cots, retain_graph=True)

        def plain():
            return fa.flash_attention_backward_reference(
                q, k, v, o_, lse_, do, dlse, causal=causal, scale=scale,
                offset=off)

        got = eager()
        want = plain()
        torch.cuda.synchronize()
        errs = []
        for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
            err = (g.float() - w.float()).abs().max().item()
            ref = w.float().abs().max().item()
            if not err <= BWD_TOL[dtype] * ref:
                raise AssertionError(f"K2 {name} {gname}: max err {err:.3e} "
                                     f"> {BWD_TOL[dtype]} x {ref:.3e}")
            errs.append(err)
        if off < 0:
            dead = -off                 # q rows that see no kv column
            if not torch.all(got[0][:, :dead] == 0):
                raise AssertionError(f"K2 {name}: masked rows' dq not 0")
        if not torch.equal(kernel()[0], got[0]):
            raise AssertionError(f"K2 {name}: wrapper and autograd differ")
        err = max(errs)
        big = sq >= 2048
        ms = device_ms(kernel)
        call_ms = eager_ms(eager)
        plain_ms = device_ms(plain, calls=2 if big else 10,
                             replays=2 if big else 5)
        del got, want
        library_ms = None
        if dtype == torch.bfloat16 and off == 0:
            # SDPA's is_causal aligns row 0 with col 0: the cases with no
            # offset. Its forward runs on the capture stream.
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            with torch.cuda.stream(side):
                os_ = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)

            def library():
                return torch.autograd.grad(os_, (qt, kt, vt), dot,
                                           retain_graph=True)

            library_ms = device_ms(library, side=side)
        bound, bound_by = backward_bound_ms(b, sq, skv, TRAIN_H, TRAIN_HKV,
                                            d, causal, off)
        split_bound, _ = backward_bound_ms(b, sq, skv, TRAIN_H, TRAIN_HKV,
                                           d, causal, off, products=7)
        max_err = max(max_err, err)
        row = dict(case=name, max_abs_err=err, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                   bound_by=bound_by, split_bound_ms=split_bound)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"K2 {name}: err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/"
            f"{errs[2]:.3e} kernel {ms:.4f} ms (eager backward "
            f"{call_ms:.4f} ms) plain {plain_ms:.4f} ms sdpa-bwd {lib} "
            f"bound {bound * 1e3:.2f} us ({bound_by}; the 7-product "
            f"split's {split_bound * 1e3:.2f} us)")
        if big:
            # The two kernels of K2 apart, by name, at the train shape.
            split = kernel_split_ms(kernel, ("flash_bwd_dkdv",
                                             "flash_bwd_dq"))
            row["dkdv_ms"], row["dq_ms"] = (split["flash_bwd_dkdv"],
                                            split["flash_bwd_dq"])
            log(f"K2 {name} by kernel (profiler): " + ", ".join(
                f"{k} " + ("not measured" if v is None else f"{v:.4f} ms")
                for k, v in split.items()))
        del q, k, v, do, leaves, o, lse
        torch.cuda.empty_cache()
    return rows, max_err


# The burst's prompt lengths (serve phase) 16 tokens into decoding: the
# live rows of K3's eight slots at the decode shape.
DECODE_LENGTHS = [36, 46, 116, 136, 216, 266, 416, 516]
DECODE_L, DECODE_C = 1024, 8
# The long-context row: llama3-8b's max_seq_len, eight slots spread over it.
LONG_L = 8192
LONG_LENGTHS = [1024, 2048, 3072, 4096, 5120, 6144, 7168, 8192]
L2_BYTES = 50e6                 # the H100's L2


def decode_bound_ms(lengths, h, hkv, d, cache_bytes, stage_rows,
                    max_len=DECODE_L):
    """Least time of K3 on this card: the larger of the bytes it must move
    (each live cache row's k and v, and their f32 scales for int8; the
    live staging rows; q read and o written once) over the memory rate,
    and its products (4 D flops a query head per live row) over the bf16
    tensor-core rate."""
    rows = sum(min(n, max_len) for n in lengths)
    b = len(lengths)
    nbytes = rows * hkv * d * 2 * cache_bytes + 4 * b * h * d
    if cache_bytes == 1:
        nbytes += rows * hkv * 2 * 4
    nbytes += stage_rows * b * hkv * d * 2 * 2
    flops = 4.0 * h * d * (rows + stage_rows * b)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def cold_ms(fn, n_sets: int, calls: int = 0) -> float:
    """Device time of one ``fn(i)`` call when each call reads another of
    ``n_sets`` cache sets, in turn: the rows it reads were last touched
    n_sets - 1 calls ago, so a set of sets larger than the L2 makes every
    call read from device memory, as the served step does (the layers'
    weights stream through the L2 between two calls on one layer).
    ``calls`` a replay: 2 n_sets unless more are asked for (a replay's
    launch gap is spread over them)."""
    turn = iter(range(1 << 30))
    return device_ms(lambda: fn(next(turn) % n_sets),
                     calls=max(calls, 2 * n_sets), replays=3)


def decode_sets(gen, b, max_len, lengths, n_min=1):
    """Seeded bf16 k/v cache sets and their int8 quantizations: enough
    sets that the live rows of all of them exceed twice the L2 (int8
    counted at its own size)."""
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows

    live_int8 = sum(min(n, max_len) for n in lengths) * HKV * (2 * 128 + 8)
    n = max(n_min, int(np.ceil(2 * L2_BYTES / live_int8)))
    bf16, int8 = [], []
    for _ in range(n):
        k = torch.randn(b, max_len, HKV, 128, generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn(b, max_len, HKV, 128, generator=gen,
                        device="cuda").bfloat16()
        bf16.append((k, v, {}))
        (k8, ks), (v8, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        int8.append((k8, v8, {"k_scale": ks, "v_scale": vs}))
    return bf16, int8


def decode_phase():
    """K3 against its plain version at the decode shape and at the long
    context; returns (rows, long rows, max_abs_err)."""
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import (
        decode_attention,
        launch_cluster,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, d = len(DECODE_LENGTHS), 128

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def check(name, kernel, plain):
        """max |kernel - plain| within 2e-2 x max |plain|, two calls
        bitwise equal; returns the error."""
        with torch.no_grad():
            got, want = kernel(), plain()
            again = kernel()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if not err <= 2e-2 * ref:
            raise AssertionError(f"K3 {name}: max err {err:.3e} > 2e-2 x "
                                 f"{ref:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {name}: two calls differ")
        return err

    q = rand(b, 1, H, d)
    sk, sv = rand(b, DECODE_C, HKV, d), rand(b, DECODE_C, HKV, d)
    idx = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    sets = dict(zip(("bf16", "int8"),
                    decode_sets(gen, b, DECODE_L, DECODE_LENGTHS)))
    live = torch.arange(DECODE_L, device="cuda")[None, :] < idx[:, None]
    qt = q.transpose(1, 2)

    def library(i=0):
        k, v, _ = sets["bf16"][i]
        return F.scaled_dot_product_attention(
            qt, k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=live[:, None, None, :], enable_gqa=True)

    log(f"K3 plan: {launch_cluster(d, H // HKV, False, b, HKV, DECODE_L)} "
        f"blocks a (slot, kv head) (bf16), "
        f"{launch_cluster(d, H // HKV, True, b, HKV, DECODE_L)} (int8); "
        f"{len(sets['bf16'])} cache sets for the cold times")
    rows, max_err = [], 0.0
    for name, cache, step in (("bf16", "bf16", None), ("int8", "int8", None),
                              ("bf16_staged", "bf16", DECODE_C - 1),
                              ("int8_staged", "int8", DECODE_C - 1)):
        stage = ({} if step is None else
                 {"stage_key": sk, "stage_value": sv, "stage_step": step})

        def kernel(i=0):
            k, v, scales = sets[cache][i]
            return decode_attention(q, k, v, idx, **scales, **stage)

        def plain():
            k, v, scales = sets[cache][0]
            return decode_attention_reference(q, k, v, idx, **scales,
                                              **stage)

        err = check(name, kernel, plain)
        with torch.no_grad():
            ms = cold_ms(kernel, len(sets[cache]))
            warm_ms = device_ms(kernel)
            plain_ms = device_ms(plain)
            library_ms = library_warm_ms = None
            if name == "bf16":
                library_ms = cold_ms(library, len(sets["bf16"]))
                library_warm_ms = device_ms(library)
                sdpa_err = (library().transpose(1, 2).float()
                            - plain().float()).abs().max().item()
        bound, bound_by = decode_bound_ms(
            DECODE_LENGTHS, H, HKV, d, 1 if cache == "int8" else 2,
            0 if step is None else step + 1)
        max_err = max(max_err, err)
        rows.append(dict(case=name, max_abs_err=err, ms=ms, warm_ms=warm_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_warm_ms=library_warm_ms, bound_ms=bound,
                         bound_by=bound_by))
        lib = "n/a" if library_ms is None else (
            f"{library_ms:.4f} ms cold, {library_warm_ms:.4f} warm (its err "
            f"{sdpa_err:.3e})")
        log(f"K3 {name}: err {err:.3e}, two calls equal; kernel {ms:.4f} ms "
            f"cold, {warm_ms:.4f} warm; plain {plain_ms:.4f} ms; sdpa {lib}; "
            f"bound {bound * 1e3:.2f} us ({bound_by})")
    del sets
    torch.cuda.empty_cache()

    # The long context: L = 8192, staged, bf16 and int8 caches. One set's
    # live rows (~150 MB bf16) exceed the L2, so every call is cold.
    idx_long = torch.tensor(LONG_LENGTHS, dtype=torch.int32, device="cuda")
    long_sets = dict(zip(("bf16", "int8"), decode_sets(
        gen, b, LONG_L, LONG_LENGTHS, n_min=2)))
    long_rows = []
    for cache in ("bf16", "int8"):
        stage = {"stage_key": sk, "stage_value": sv,
                 "stage_step": DECODE_C - 1}

        def kernel(i=0):
            k, v, scales = long_sets[cache][i]
            return decode_attention(q, k, v, idx_long, **scales, **stage)

        def plain():
            k, v, scales = long_sets[cache][0]
            return decode_attention_reference(q, k, v, idx_long, **scales,
                                              **stage)

        name = f"l8192_{cache}_staged"
        err = check(name, kernel, plain)
        with torch.no_grad():
            ms = cold_ms(kernel, len(long_sets[cache]))
        bound, bound_by = decode_bound_ms(
            LONG_LENGTHS, H, HKV, d, 1 if cache == "int8" else 2,
            DECODE_C, max_len=LONG_L)
        max_err = max(max_err, err)
        long_rows.append(dict(case=name, max_abs_err=err, ms=ms,
                              bound_ms=bound, bound_by=bound_by))
        log(f"K3 {name}: err {err:.3e}, two calls equal; kernel {ms:.4f} ms "
            f"cold; bound {bound * 1e3:.2f} us ({bound_by})")
    del long_sets
    torch.cuda.empty_cache()
    paged_rows, paged_err = decode_paged_cases(gen, check)
    return rows, long_rows, paged_rows, max(max_err, paged_err)


# K3 by block table at the paged serve phase's decode shape: 48 slots,
# max_len 512 in 16-row pages, live rows 128-255, 32 staging rows.
PAGED_B, PAGED_L, PAGED_BS, PAGED_C = 48, 512, 16, 32
PAGED_LENGTHS = [128 + (37 * i) % 128 for i in range(PAGED_B)]


def decode_paged_cases(gen, check):
    """K3 reading a pool through a table that is a random permutation of
    its pages, bf16 and int8, staged: against the plain version
    (paged_decode_attention: gather, then decode_attention_reference) within
    2e-2 x max |plain|, bitwise against K3's dense call over the gathered
    rows; both timed cold (pool sets whose live rows exceed twice the L2)
    beside each other. Returns (rows, max_abs_err)."""
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.paged_attention import (
        gather_cache,
        paged_decode_attention,
    )

    b, d, nb = PAGED_B, 128, PAGED_L // PAGED_BS
    q = torch.randn(b, 1, H, d, generator=gen, device="cuda").bfloat16()
    stage = {name: torch.randn(b, PAGED_C, HKV, d, generator=gen,
                               device="cuda").bfloat16()
             for name in ("stage_key", "stage_value")}
    step = PAGED_C - 1
    idx = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    q_pos = (idx.long() + step)[:, None]
    live = sum(PAGED_LENGTHS) * HKV * (2 * 128 + 8)
    n_sets = max(2, int(np.ceil(2 * L2_BYTES / live)))
    rows, max_err = [], 0.0
    for cache in ("bf16", "int8"):
        sets = []
        for _ in range(n_sets):
            k, v = (torch.randn(b * nb + 1, PAGED_BS, HKV, d, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            scales = {}
            if cache == "int8":
                (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
                scales = {"k_scale": ks, "v_scale": vs}
            tables = torch.randperm(b * nb, generator=gen, device="cuda")\
                .view(b, nb).int()
            dk, dv, dks, dvs = gather_cache(tables, PAGED_BS, k, v,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
            dense = {} if dks is None else {"k_scale": dks, "v_scale": dvs}
            sets.append(((k, v, scales, tables), (dk, dv, dense)))

        def kernel(i=0):
            k, v, scales, tables = sets[i][0]
            return decode_attention(q, k, v, idx, **scales, **stage,
                                    stage_step=step, block_tables=tables,
                                    block_size=PAGED_BS)

        def dense_call(i=0):
            dk, dv, dense = sets[i][1]
            return decode_attention(q, dk, dv, idx, **dense, **stage,
                                    stage_step=step)

        def plain():
            k, v, scales, tables = sets[0][0]
            return paged_decode_attention(
                q, k, v, tables, q_pos, PAGED_BS,
                key_scale_pool=scales.get("k_scale"),
                value_scale_pool=scales.get("v_scale"), **stage,
                stage_step=step)

        name = f"paged_{cache}_staged"
        err = check(name, kernel, plain)
        with torch.no_grad():
            if not torch.equal(kernel(), dense_call()):
                raise AssertionError(f"K3 {name}: not bitwise equal to the "
                                     "dense call over the same rows")
            ms = cold_ms(kernel, n_sets)
            dense_ms = cold_ms(dense_call, n_sets)
            ms_again = cold_ms(kernel, n_sets)
            dense_again = cold_ms(dense_call, n_sets)
            plain_ms = device_ms(plain)
        bound, bound_by = decode_bound_ms(
            PAGED_LENGTHS, H, HKV, d, 1 if cache == "int8" else 2, PAGED_C,
            max_len=PAGED_L)
        max_err = max(max_err, err)
        rows.append(dict(case=name, max_abs_err=err, ms=ms,
                         ms_again=ms_again, dense_ms=dense_ms,
                         dense_again=dense_again, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by))
        log(f"K3 {name} (B {b}, L {PAGED_L}, {PAGED_BS}-row pages, shuffled "
            f"table): err {err:.3e}, two calls equal, bitwise the dense "
            f"call; cold in turns paged {ms:.5f} / dense {dense_ms:.5f} / "
            f"paged {ms_again:.5f} / dense {dense_again:.5f} ms; plain "
            f"{plain_ms:.4f} ms; bound {bound * 1e3:.2f} us ({bound_by})")
        del sets
        torch.cuda.empty_cache()
    return rows, max_err


# llama3-8b's products with int8 weights at the decode step (M = 8 slots):
# name -> (N, K, scale period S); then the gate shape at other token counts
# (prefill groups k_pad x bucket up to 8 x 512, the extend's 512 rows, a
# group of two 512-token prompts); then the grouped launches of products
# that read the same x (q/k/v, gate/up) at M = 8.
INT8_SHAPES = {
    "q_proj": (4096, 4096, 1), "k_proj": (1024, 4096, 1),
    "v_proj": (1024, 4096, 1), "o_proj": (4096, 4096, 128),
    "gate_proj": (14336, 4096, 1), "up_proj": (14336, 4096, 1),
    "down_proj": (4096, 14336, 1), "lm_head": (128256, 4096, 1),
}
INT8_GATE_M = (1, 9, 64, 512, 1024, 4096)
INT8_GROUPS = {"qkv_group": ("q_proj", "k_proj", "v_proj"),
               "gateup_group": ("gate_proj", "up_proj")}
# The token counts of the paged path: its decode batch (48 slots), a
# smaller one (32) and its extend chunk (128), for each launch a layer
# makes (the q/k/v and gate/up groups, o and down).
INT8_PAGED_M = (32, 48, 128)
INT8_LAYER = {"qkv_group": INT8_GROUPS["qkv_group"], "o_proj": ("o_proj",),
              "gateup_group": INT8_GROUPS["gateup_group"],
              "down_proj": ("down_proj",)}
INT8_TOL = 1e-2         # max |K4 - plain| <= INT8_TOL x max |plain|


def int8_bound_ms(m, ns, k, period):
    """Least time of K4 on this card: the larger of the bytes it must move
    (each int8 weight of ``ns`` rows, its bf16 scales, x read once, y
    written once) over the memory rate and its products over the bf16
    tensor-core rate."""
    nbytes = sum(n * k + 2 * n * period + 2 * m * n for n in ns) + 2 * m * k
    t_ops, t_bytes = 2.0 * m * sum(ns) * k / PEAK_BF16_FLOPS, \
        nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def int8_phase():
    """K4 against its plain version at llama3-8b's decode products (M = 8),
    at the gate shape for other token counts and at the grouped launches
    (q/k/v, gate/up at M = 8); returns (rows, max_abs_err). Cold times
    rotate over weight sets whose bytes exceed twice the L2 (the served
    step reads each layer's weights once); the library yardstick is
    F.linear on the weight dequantized beforehand (bf16, twice the bytes;
    a group's weights concatenated, one call), which the port never
    calls."""
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.serving.engine import _quantize_leaf
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(name, 8, (name,)) for name in INT8_SHAPES]
    cases += [(f"gate_m{m}", m, ("gate_proj",)) for m in INT8_GATE_M]
    cases += [(name, 8, members) for name, members in INT8_GROUPS.items()]
    cases += [(f"{name}_m{m}", m, members) for m in INT8_PAGED_M
              for name, members in INT8_LAYER.items()]
    rows, max_err = [], 0.0
    for name, m, members in cases:
        ns = [INT8_SHAPES[p][0] for p in members]
        _, k, period = INT8_SHAPES[members[0]]
        n_sets = max(2, int(np.ceil(2 * L2_BYTES / (sum(ns) * k))))
        sets, plain_w = [], []
        for _ in range(n_sets):
            pairs = []
            for n in ns:
                w = torch.randn(n, k, generator=gen, device="cuda") * 0.02
                pairs.append(_quantize_leaf(w, period))
                del w
            sets.append(pairs)
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        lib_sets = max(2, int(np.ceil(2 * L2_BYTES / (2 * sum(ns) * k))))
        for i in range(lib_sets):
            plain_w.append(torch.cat([il.dequantize_int8(*pair)
                                      for pair in sets[i % n_sets]]))

        def kernel(i=0, splits=0):
            if len(ns) > 1:
                return il._group_kernel(x, sets[i], None, splits=splits)
            return (il._kernel(x, *sets[i][0], None, splits=splits),)

        def plain():
            return [il.int8_linear_reference(x, *pair) for pair in sets[0]]

        def library(i=0):
            return F.linear(x, plain_w[i])

        with torch.no_grad():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            ref = max(b.float().abs().max().item() for b in want)
            if not err <= INT8_TOL * ref:
                raise AssertionError(f"K4 {name}: max err {err:.3e} > "
                                     f"{INT8_TOL} x {ref:.3e}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K4 {name}: two calls differ")
            del got, again, want
            ms = cold_ms(kernel, n_sets, calls=10)
            warm_ms = device_ms(kernel)
            plain_ms = device_ms(plain, calls=2, replays=3)
            library_ms = cold_ms(library, lib_sets, calls=10)
            library_warm_ms = device_ms(library)
            splits = {}
            if m <= 16 and len(ns) == 1:   # the decode kernel's K split
                for c in (1, 2, 4, 8):
                    splits[c] = cold_ms(lambda i, c=c: kernel(i, c), n_sets,
                                        calls=10)
        bound, bound_by = int8_bound_ms(m, ns, k, period)
        max_err = max(max_err, err)
        rows.append(dict(case=name, m=m, max_abs_err=err, ms=ms,
                         warm_ms=warm_ms, plain_ms=plain_ms,
                         library_ms=library_ms,
                         library_warm_ms=library_warm_ms, bound_ms=bound,
                         bound_by=bound_by))
        log(f"K4 {name} (M {m}, N {'+'.join(map(str, ns))}, K {k}, S "
            f"{period}): err {err:.3e}, two calls equal; kernel "
            f"{ms * 1e3:.2f} us cold ({n_sets} weight sets), "
            f"{warm_ms * 1e3:.2f} warm; plain {plain_ms * 1e3:.2f} us; "
            f"F.linear on bf16 weights {library_ms * 1e3:.2f} us cold, "
            f"{library_warm_ms * 1e3:.2f} warm; bound {bound * 1e3:.2f} us "
            f"({bound_by}; kernel at {bound / ms:.2f} of it)"
            + ("" if len(ns) > 1 else
               f"; K split over a cluster of "
               f"{il._kernel_fns()[0](m, ns[0], k, period)}") + "".join(
                f"; over {c}: {v * 1e3:.2f} us cold"
                for c, v in splits.items()))
        del sets, plain_w, x
        torch.cuda.empty_cache()
    rows += int8_swiglu_rows(gen)
    by = {r["case"]: r for r in rows}
    # A decode step's products: 32 layers x 7 + lm_head launched apart (225
    # launches), or with q/k/v and gate/up grouped (32 x 4 + 1 = 129).
    apart = dict(q_proj=32, k_proj=32, v_proj=32, o_proj=32, gate_proj=32,
                 up_proj=32, down_proj=32, lm_head=1)
    grouped = dict(qkv_group=32, o_proj=32, gateup_group=32, down_proj=32,
                   lm_head=1)
    step = {}
    for kind, counts in (("apart", apart), ("grouped", grouped)):
        step[kind] = {key: sum(by[c][key] * n for c, n in counts.items())
                      for key in ("ms", "warm_ms", "bound_ms", "library_ms")}
        log(f"K4 over a decode step's products, {kind} "
            f"({sum(counts.values())} launches): " + ", ".join(
                f"{key} {v:.3f}" for key, v in step[kind].items()))
    return rows, max_err, step


def int8_swiglu_rows(gen) -> list:
    """K4's SwiGLU epilogue at the decode step's M = 8, gate and up as two
    weights (the group) and as the halves of the fused [2F, K] weight:
    bitwise K4's grouped launch followed by K9 at the same K split (each
    split of 1, 2, 4, 8 and the kernel's own), within INT8_TOL of the
    plain version (int8_linear_swiglu_reference). Timed cold beside what
    it replaces in the same call: the grouped K4 launch alone (its time
    must stay that of the group without the epilogue) and the group then
    K9. Returns the rows (no library call computes it)."""
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.ops import swiglu as sw
    from kubeflow_tpu_torch.serving.engine import _quantize_leaf

    F_, k = INT8_SHAPES["gate_proj"][:2]
    m = 8
    n_sets = max(2, int(np.ceil(2 * L2_BYTES / (2 * F_ * k))))
    rows = []
    for fused in (False, True):
        name = "gateup_fused_swiglu" if fused else "gateup_swiglu"
        sets = []
        for _ in range(n_sets):
            w = torch.randn(2 * F_, k, generator=gen, device="cuda") * 0.02
            if fused:
                q, scale = _quantize_leaf(w, 1)
                sets.append(((q[:F_], scale[:F_]), (q[F_:], scale[F_:])))
            else:
                sets.append((_quantize_leaf(w[:F_].contiguous(), 1),
                             _quantize_leaf(w[F_:].contiguous(), 1)))
            del w
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()

        def epilogue(i=0, splits=0):
            return il._swiglu_kernel(x, *sets[i], None, splits=splits)

        def group(i=0, splits=0):
            return il._group_kernel(x, list(sets[i]), None, splits=splits)

        def group_k9(i=0, splits=0):
            return sw._fwd_kernel(*group(i, splits))

        with torch.no_grad():
            for splits in (0, 1, 2, 4, 8):
                _bitwise(f"K4 {name} split {splits}",
                         [(epilogue(0, splits), group_k9(0, splits))])
            got = epilogue()
            want = il.int8_linear_swiglu_reference(x, *sets[0])
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            if not err <= INT8_TOL * ref or not torch.equal(got, epilogue()):
                raise AssertionError(f"K4 {name}: max err {err:.3e} > "
                                     f"{INT8_TOL} x {ref:.3e}, or two calls "
                                     "differ")
            row = dict(case=name, m=m, max_abs_err=err, library_ms=None,
                       library_warm_ms=None)
            for key, fn in (("ms", epilogue), ("group_ms", group),
                            ("group_k9_ms", group_k9), ("ms", epilogue)):
                # The epilogue timed first and last; its least is kept.
                ms = cold_ms(fn, n_sets, calls=10)
                row[key] = min(ms, row.get(key, ms))
            row["warm_ms"] = device_ms(epilogue)
            row["plain_ms"] = device_ms(
                lambda: il.int8_linear_swiglu_reference(x, *sets[0]),
                calls=2, replays=3)
        # x and both weights read once, h written once; the products.
        nbytes = 2 * (F_ * k + 2 * F_) + 2 * m * k + 2 * m * F_
        t_ops = 2.0 * m * 2 * F_ * k / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S
        row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
        rows.append(row)
        log(f"K4 {name} (M {m}, gate/up {F_} x {k}, S 1): bitwise the "
            f"grouped K4 then K9 at splits 0, 1, 2, 4, 8; err {err:.3e}; "
            f"kernel {row['ms'] * 1e3:.2f} us cold ({n_sets} weight sets), "
            f"{row['warm_ms'] * 1e3:.2f} warm; in the same call the grouped "
            f"K4 alone {row['group_ms'] * 1e3:.2f} us, then K9 "
            f"{row['group_k9_ms'] * 1e3:.2f}; plain "
            f"{row['plain_ms'] * 1e3:.2f} us; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
        del sets, x
        torch.cuda.empty_cache()
    return rows


# The train step's shapes for the fused kernels (K5-K8).
TRAIN_ROWS = TRAIN_BATCH * (TRAIN_SEQ - 1)       # 24564 tokens a step
SERVE_E = 4096                                    # llama3-8b's width


def bytes_ms(nbytes: float) -> float:
    """The least time for moving ``nbytes`` through device memory."""
    return nbytes / PEAK_BYTES_PER_S * 1e3


def sets_for(call_bytes: float) -> int:
    """Cache sets whose bytes exceed twice the L2 (1: a call is larger)."""
    return max(1, int(np.ceil(2 * L2_BYTES / call_bytes)))


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| in bf16 ulps of max(|want|, 2^-8 max |want|): the
    card tests' K6/K7 bound (tests/test_torch_cuda.py::_ulp_ok)."""
    w = want.float()
    scale = w.abs().clamp_min(2 ** -8 * float(w.abs().max()))
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(((got.float() - w).abs() / ulp).max())


def timed(fn, call_bytes: float, big: bool = False) -> float:
    """Device ms of ``fn(i)``: cold over sets_for(call_bytes) sets when
    several are needed, else CUDA-graph replays of one set."""
    n = sets_for(call_bytes)
    if n > 1:
        return cold_ms(fn, n)
    return device_ms(lambda: fn(0), calls=2 if big else 10,
                     replays=3 if big else 5)


def library_bwd_ms(forward, leaves, cot) -> float:
    """Device ms of the backward of ``forward(*leaves)`` (a library call
    the port never makes), grads of a retained graph whose forward ran on
    the capture stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*leaves)
    return device_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                 retain_graph=True),
                     calls=2, replays=3, side=side)


def fused_phase():
    """K5-K8, the training step's fused element-wise work, against their
    plain versions on the same inputs: K6 (RMSNorm) and K7 (RoPE) at the
    train shapes (forward and backward) and at llama3-8b's serving shapes
    (forward), within one bf16 ulp and two calls bitwise equal; K8 (the
    cross-entropy) at [24564, 32000] bf16, loss within relative 1e-5,
    dlogits within 2e-2 x max |plain|, hits equal; K5 (the optimizer) over
    the 700M model's 111 tensors, bitwise equal to the plain update given
    the same norm, the norm within relative 1e-6 of an f64 sum. Times each
    kernel (cold over sets larger than twice the L2 where a call is
    smaller), its plain version and the library call the port never makes
    (F.rms_norm, F.cross_entropy, torch.optim.AdamW(fused=True); none for
    RoPE), beside the byte bound. Returns {kernel: {case: row}}."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
    from kubeflow_tpu_torch.ops import cross_entropy as ce
    from kubeflow_tpu_torch.ops import norms, rope
    from kubeflow_tpu_torch.ops import optimizer as fused

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {"K5": {}, "K6": {}, "K7": {}, "K8": {}}

    # ---- K6: RMSNorm.
    for case, rows_, E, train in (("train", TRAIN_ROWS, 2048, True),
                                  ("decode", 8, SERVE_E, False),
                                  ("prefill", 4096, SERVE_E, False)):
        call = 2 * rows_ * E * 2
        xs = [torch.randn(rows_, E, generator=gen, device="cuda").bfloat16()
              for _ in range(sets_for(call))]
        w = (1 + 0.1 * torch.randn(E, generator=gen, device="cuda")
             ).bfloat16()
        x = xs[0]
        y, rstd = norms._fwd_kernel(x, w, 1e-6)
        want, want_r = norms.rms_norm_reference(x, w, eps=1e-6)
        err = ulps(y, want)
        if err > 1 or not torch.equal(norms._fwd_kernel(x, w, 1e-6)[0], y):
            raise AssertionError(f"K6 {case} forward: {err:.2f} ulp or two "
                                 "calls differ")
        row = dict(max_abs_err=float((y.float() - want.float()).abs().max()),
                   ulps=err, rows=rows_, width=E)
        row["ms"] = timed(lambda i: norms._fwd_kernel(xs[i], w, 1e-6), call,
                          train)
        if rows_ <= norms.ROWS_MAX:     # the rows kernel; a block a row
            row["block_ms"] = timed(lambda i: norms._fwd_kernel(
                xs[i], w, 1e-6, by_rows=False), call, train)
        row["plain_ms"] = device_ms(
            lambda: norms.rms_norm_reference(x, w, eps=1e-6),
            calls=2 if train else 10, replays=3 if train else 5)
        row["library_ms"] = timed(
            lambda i: F.rms_norm(xs[i], (E,), w, 1e-6), call, train)
        row["bound_ms"] = bytes_ms(call + 2 * E + 4 * rows_)
        if train:
            dy = torch.randn(rows_, E, generator=gen, device="cuda").bfloat16()
            dx, dw = norms._bwd_kernel(x, w, dy, rstd)
            pdx, pdw = norms.rms_norm_backward_reference(x, w, dy, rstd)
            berr = max(ulps(dx, pdx), ulps(dw, pdw))
            again = norms._bwd_kernel(x, w, dy, rstd)
            if berr > 1 or not (torch.equal(again[0], dx)
                                and torch.equal(again[1], dw)):
                raise AssertionError(f"K6 {case} backward: {berr:.2f} ulp "
                                     "or two calls differ")
            row["bwd_ulps"] = berr
            row["bwd_ms"] = device_ms(
                lambda: norms._bwd_kernel(x, w, dy, rstd), calls=2,
                replays=3)
            row["bwd_plain_ms"] = device_ms(
                lambda: norms.rms_norm_backward_reference(x, w, dy, rstd),
                calls=2, replays=3)
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            row["bwd_library_ms"] = library_bwd_ms(
                lambda a, b: F.rms_norm(a, (E,), b, 1e-6), (xl, wl), dy)
            row["bwd_bound_ms"] = bytes_ms(3 * rows_ * E * 2 + 4 * E
                                           + 4 * rows_)
            del dy, dx, dw, pdx, pdw, again, xl, wl
        out["K6"][case] = row
        log(f"K6 {case} [{rows_}, {E}] bf16: {err:.2f} ulp, kernel "
            f"{row['ms']:.4f} ms"
            + (f" (rows kernel; a block a row {row['block_ms']:.4f})"
               if "block_ms" in row else "")
            + f", plain {row['plain_ms']:.4f}, F.rms_norm "
            f"{row['library_ms']:.4f}, bound {row['bound_ms']:.5f} (bytes)"
            + (f"; backward {row['bwd_ulps']:.2f} ulp, kernel "
               f"{row['bwd_ms']:.4f} ms, plain {row['bwd_plain_ms']:.4f}, "
               f"F.rms_norm's {row['bwd_library_ms']:.4f}, bound "
               f"{row['bwd_bound_ms']:.4f}" if train else ""))
        del xs, x, y, want

    # ---- K7: RoPE of q and k in one launch.
    cos, sin = rope.rope_frequencies(128, 2048, theta=500000.0,
                                     device="cuda")
    for case, (b, s, hq, hk), train in (
            ("train", (TRAIN_BATCH, TRAIN_SEQ - 1, TRAIN_H, TRAIN_HKV), True),
            ("decode", (8, 1, H, HKV), False),
            ("paged", (48, 1, H, HKV), False),
            ("prefill", (1, 512, H, HKV), False)):
        call = 2 * b * s * (hq + hk) * 128 * 2
        n = sets_for(call)
        qs = [torch.randn(b, s, hq, 128, generator=gen,
                          device="cuda").bfloat16() for _ in range(n)]
        ks = [torch.randn(b, s, hk, 128, generator=gen,
                          device="cuda").bfloat16() for _ in range(n)]
        pos = (torch.arange(s, device="cuda").expand(b, s) if train else
               torch.randint(0, 1024, (b, s), generator=gen, device="cuda"))
        q, k = qs[0], ks[0]
        qo, ko = rope._kernel(q, k, cos, sin, pos, False)
        pq = rope.rope_reference(q, cos, sin, positions=pos)
        pk = rope.rope_reference(k, cos, sin, positions=pos)
        err = max(ulps(qo, pq), ulps(ko, pk))
        abs_err = max(float((qo.float() - pq.float()).abs().max()),
                      float((ko.float() - pk.float()).abs().max()))
        del pq, pk
        again = rope._kernel(q, k, cos, sin, pos, False)
        if err > 1 or not (torch.equal(again[0], qo)
                           and torch.equal(again[1], ko)):
            raise AssertionError(f"K7 {case}: {err:.2f} ulp or two calls "
                                 "differ")
        table = int(pos.clamp(0, 2047).unique().numel()) * 64 * 4 * 2
        row = dict(max_abs_err=abs_err, ulps=err, library_ms=None,
                   bound_ms=bytes_ms(call + table + pos.numel() * 8))
        row["ms"] = timed(lambda i: rope._kernel(qs[i], ks[i], cos, sin, pos,
                                                 False), call, train)

        def plain():
            return (rope.rope_reference(q, cos, sin, positions=pos),
                    rope.rope_reference(k, cos, sin, positions=pos))

        row["plain_ms"] = device_ms(plain, calls=2 if train else 10,
                                    replays=3 if train else 5)
        if train:
            row["bwd_ms"] = device_ms(
                lambda: rope._kernel(q, k, cos, sin, pos, True), calls=2,
                replays=3)
            row["bwd_bound_ms"] = row["bound_ms"]
        out["K7"][case] = row
        log(f"K7 {case} q {list(q.shape)} k {list(k.shape)} bf16: "
            f"{err:.2f} ulp, kernel {row['ms']:.4f} ms"
            + (f" (backward {row['bwd_ms']:.4f})" if train else "")
            + f", plain {row['plain_ms']:.4f}, library n/a, bound "
            f"{row['bound_ms']:.5f} (bytes)")
        del qs, ks, q, k, qo, ko, again

    # ---- K8: the cross-entropy over the train step's bf16 logits.
    V = TRAIN_MODEL_KW["vocab_size"]
    logits = (torch.randn(TRAIN_ROWS, V, generator=gen, device="cuda") * 4
              ).bfloat16()
    labels = torch.randint(0, V, (TRAIN_ROWS,), generator=gen,
                           device="cuda")
    labels[::7] = logits[::7].float().argmax(-1)
    zw = 1e-4                                    # the trainer's z-loss
    sums, logz = ce._fwd_kernel(logits, labels, None, zw, 0.0)
    want, want_logz = ce.cross_entropy_reference(logits, labels, None, zw,
                                                 0.0)
    g = (1.0 / want[1]).reshape(1)
    d = ce._bwd_kernel(logits, labels, None, logz, g, zw, 0.0)
    want_d = ce.cross_entropy_backward_reference(logits, labels, None,
                                                 want_logz, g, zw, 0.0)
    rel = abs(float(sums[0]) - float(want[0])) / abs(float(want[0]))
    derr = float((d.float() - want_d.float()).abs().max())
    dref = float(want_d.float().abs().max())
    same = (torch.equal(ce._fwd_kernel(logits, labels, None, zw, 0.0)[0],
                        sums)
            and torch.equal(ce._bwd_kernel(logits, labels, None, logz, g, zw,
                                           0.0), d))
    if rel > 1e-5 or derr > 2e-2 * dref or float(sums[2]) != float(want[2]) \
            or float(sums[1]) != float(want[1]) or not same:
        raise AssertionError(f"K8: loss rel {rel:.2e}, dlogits {derr:.3e} "
                             f"(bound 2e-2 x {dref:.3e}), hits "
                             f"{float(sums[2])} vs {float(want[2])}, two "
                             f"calls equal {same}")
    del want_d
    nbytes = logits.numel() * 2
    row = dict(max_abs_err=derr, loss_rel_err=rel,
               bound_ms=bytes_ms(nbytes + TRAIN_ROWS * 12),
               bwd_bound_ms=bytes_ms(2 * nbytes + TRAIN_ROWS * 12))
    row["ms"] = device_ms(lambda: ce._fwd_kernel(logits, labels, None, zw,
                                                 0.0), calls=2, replays=3)
    row["bwd_ms"] = device_ms(lambda: ce._bwd_kernel(
        logits, labels, None, logz, g, zw, 0.0), calls=2, replays=3)
    row["plain_ms"] = device_ms(lambda: ce.cross_entropy_reference(
        logits, labels, None, zw, 0.0), calls=1, replays=2)
    row["bwd_plain_ms"] = device_ms(
        lambda: ce.cross_entropy_backward_reference(
            logits, labels, None, logz, g, zw, 0.0), calls=1, replays=2)
    row["library_ms"] = device_ms(lambda: F.cross_entropy(logits, labels),
                                  calls=2, replays=3)
    xl = logits.clone().requires_grad_()
    row["bwd_library_ms"] = library_bwd_ms(
        lambda a: F.cross_entropy(a, labels), (xl,), None)
    out["K8"]["train"] = row
    log(f"K8 [{TRAIN_ROWS}, {V}] bf16, z-loss {zw}: loss rel err "
        f"{rel:.2e}, dlogits err {derr:.3e} of {dref:.3e}, hits "
        f"{int(sums[2])}; kernel forward {row['ms']:.4f} ms, backward "
        f"{row['bwd_ms']:.4f}; plain {row['plain_ms']:.4f} / "
        f"{row['bwd_plain_ms']:.4f}; F.cross_entropy (no z-loss) "
        f"{row['library_ms']:.4f} / {row['bwd_library_ms']:.4f}; bound "
        f"{row['bound_ms']:.4f} / {row['bwd_bound_ms']:.4f} (bytes)")
    del logits, labels, logz, d, xl, want
    torch.cuda.empty_cache()

    # ---- K5: the optimizer over the 700M model's tensors.
    with torch.device("meta"):
        shapes = [p.shape for p in Llama(LlamaConfig(
            **TRAIN_MODEL_KW)).parameters()]
    params = [(torch.randn(s, generator=gen, device="cuda") * 0.02
               ).bfloat16() for s in shapes]
    grads = [(torch.randn(s, generator=gen, device="cuda") * 1e-4
              ).bfloat16() for s in shapes]
    mu = [(torch.randn(s, generator=gen, device="cuda") * 1e-5).bfloat16()
          for s in shapes]
    nu = [torch.rand(s, generator=gen, device="cuda") * 1e-8 for s in shapes]
    n = sum(p.numel() for p in params)
    norm = fused.global_norm(grads)
    exact = sum(float((t.double() ** 2).sum()) for t in grads) ** 0.5
    nrel = abs(float(norm) - exact) / exact
    if nrel > 1e-6 or not torch.equal(fused.global_norm(grads), norm):
        raise AssertionError(f"K5 norm: rel err {nrel:.2e} against f64, or "
                             "two calls differ")
    hyper = fused.Hyper(max_norm=1.0, b1=0.9, b2=0.95, bc1=0.19,
                        bc2=0.0975, weight_decay=0.1, lr=3e-4)
    for clip in (1.0, 1e-4):            # not clipped, clipped
        h = dataclasses.replace(hyper, max_norm=clip)
        copies = [[t.clone() for t in ts] for ts in (params, mu, nu)]
        fused.update("adamw", params, grads, mu, nu, norm, h)
        fused.update_reference("adamw", copies[0], grads, copies[1],
                               copies[2], norm, h)
        if not all(torch.equal(a, b) for a, b in zip(
                params + mu + nu, sum(copies, []))):
            raise AssertionError(f"K5 update (max_norm {clip}) is not "
                                 "bitwise the plain update")
        del copies
    torch.cuda.empty_cache()
    row = dict(max_abs_err=0.0, norm_rel_err=nrel, tensors=len(params),
               params=n, chunks=sum(fused.chunks_of(p.numel())
                                    for p in params))
    row["norm_ms"] = device_ms(lambda: fused.global_norm(grads), calls=2,
                               replays=3)
    row["update_ms"] = device_ms(lambda: fused.update(
        "adamw", params, grads, mu, nu, norm, hyper), calls=2, replays=3)
    row["ms"] = row["norm_ms"] + row["update_ms"]
    row["plain_ms"] = device_ms(lambda: (
        fused.global_norm_reference(grads),
        fused.update_reference("adamw", params, grads, mu, nu, norm,
                               hyper)), calls=1, replays=2)
    row["norm_bound_ms"] = bytes_ms(2 * n)
    row["update_bound_ms"] = bytes_ms(18 * n)
    row["bound_ms"] = row["norm_bound_ms"] + row["update_bound_ms"]
    leaves = [p.detach().clone().requires_grad_() for p in params]
    for leaf, gr in zip(leaves, grads):
        leaf.grad = gr
    opt = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.95),
                            weight_decay=0.1, fused=True)
    row["library_ms"] = eager_ms(opt.step, iters=5, repeats=3)
    out["K5"]["train"] = row
    log(f"K5 {len(params)} tensors, {n / 1e6:.1f}M params (bf16 p, g, mu; "
        f"f32 nu), {row['chunks']} chunks: norm rel err {nrel:.2e}, update "
        f"bitwise the plain one (clipped and not); kernel norm "
        f"{row['norm_ms']:.4f} + update {row['update_ms']:.4f} = "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
        f"torch.optim.AdamW(fused=True) step {row['library_ms']:.4f} "
        f"(eager; no clip, its own eps and bf16 moments), bound "
        f"{row['norm_bound_ms']:.4f} + {row['update_bound_ms']:.4f} (bytes)")
    del params, grads, mu, nu, leaves, opt
    torch.cuda.empty_cache()
    out["K7"].update(rope_strided_rows(gen))
    out["K7"].update(rope_stage_rows(gen))
    out["K9"] = swiglu_rows(gen)
    out["K10"] = add_norm_rows(gen)
    return out


#: K11's seven passes, by the names of their device kernels.
K11_PASSES = ("::tile_stats", "::norm_reduce", "::moments", "::row_factors",
              "::tile_u2", "::leaf_sums", "::apply_update")
#: What the adafactor step cost in PR 14's final run (run J): K5's norm in
#: front of K11, and K11's three tile passes (ms).
K11_PR14_MS, K11_PR14_TILE_MS = 4.54, 3.60


def adafactor_phase():
    """K11 (the adafactor update, the gradients' global norm included) over
    the 700M model's 111 tensors at their real shapes, bf16 params and
    grads, the JAX leaves stacked (scan_layers=True), moments of earlier
    steps: against its plain version on the same inputs, clipped and not,
    moments within 1e-6 relative of the plain version in f64 and params
    within one bf16 ulp of it in f32, two calls bitwise equal, the norm it
    computes within 1e-6 relative of K5's global_norm.
    Times K11 (CUDA-graph replays; each pass by kernel name beside its own
    bytes), the plain version and torch.optim.Adafactor's step on the same
    tensors (eager; not the same function: its own eps, clip and relative
    step), beside the byte bound (g read, p read and written once).
    Returns the row."""
    from kubeflow_tpu_torch.models.layout import jax_leaves
    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
    from kubeflow_tpu_torch.ops import adafactor
    from kubeflow_tpu_torch.ops import optimizer as fused

    cfg = LlamaConfig(**TRAIN_MODEL_KW)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in Llama(cfg).named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(14)
    mk = lambda s, sc: (torch.randn(s, generator=gen, device="cuda")  # noqa: E731
                        * sc).bfloat16()
    params = {n: mk(s, 0.02) for n, s in shapes.items()}
    grads = {n: mk(s, 1e-4) for n, s in shapes.items()}
    leaves = jax_leaves(cfg)
    state = adafactor.init_state(params, leaves)
    moments = [m for k in ("v_row", "v_col", "v")
               for m in state[k].values()]
    for m in moments:                           # moments of earlier steps
        m.copy_(torch.rand(m.shape, generator=gen, device="cuda") * 1e-8
                + 1e-10)
    n = sum(p.numel() for p in params.values())
    k5_norm = fused.global_norm(list(grads.values()))
    hyper = adafactor.Hyper(max_norm=1.0, count=3, lr=3e-4,
                            weight_decay=0.1)

    def copy(d):
        return {k: ({m: t.clone() for m, t in v.items()}
                    if isinstance(v, dict) else v) for k, v in d.items()}

    worst, rel, abs_err, nrel = 0.0, 0.0, 0.0, 0.0
    for clip in (1.0, 1e4):                      # clipped, not clipped
        h = dataclasses.replace(hyper, max_norm=clip)
        p_k, p_k2, p_p, p_64 = ({k: t.clone() for k, t in params.items()}
                                for _ in range(4))
        s_k, s_k2, s_p, s_64 = (copy(state) for _ in range(4))
        norm = adafactor.update(p_k, grads, s_k, leaves, h)
        norm2 = adafactor.update(p_k2, grads, s_k2, leaves, h)
        adafactor.update_reference(p_p, grads, s_p, leaves, h)
        adafactor.update_reference(p_64, grads, s_64, leaves, h,
                                   dtype=torch.float64)
        del p_64
        if not torch.equal(norm, norm2):
            raise AssertionError("K11 norm: two calls differ")
        nrel = max(nrel, abs(float(norm) - float(k5_norm)) / float(k5_norm))
        for k in params:
            if not torch.equal(p_k[k], p_k2[k]):
                raise AssertionError(f"K11 {k}: two calls differ")
            worst = max(worst, ulps(p_k[k], p_p[k]))
            abs_err = max(abs_err, float((p_k[k].float()
                                          - p_p[k].float()).abs().max()))
        for key in ("v_row", "v_col", "v"):
            for k, m in s_k[key].items():
                if not torch.equal(m, s_k2[key][k]):
                    raise AssertionError(f"K11 {key} {k}: two calls differ")
                want = s_64[key][k]
                rel = max(rel, float(((m - want).abs() / want.abs()).max()))
        del p_k, p_k2, p_p, s_k, s_k2, s_p, s_64
        torch.cuda.empty_cache()
    if worst > 1 or rel > 1e-6 or nrel > 1e-6:
        raise AssertionError(f"K11: params {worst:.2f} ulp, moments "
                             f"{rel:.2e} relative from the plain version, "
                             f"norm {nrel:.2e} relative from K5's")
    blocks = len(adafactor.blocks(params, leaves))
    factored = len(state["v_row"])
    row = dict(max_abs_err=abs_err, ulps=worst, moment_rel_err=rel,
               norm_rel_err=nrel, tensors=len(params), params=n,
               blocks=blocks, factored=factored, bound_by="bytes",
               inflight_bytes_per_sm=adafactor.inflight_bytes())
    row["ms"] = device_ms(lambda: adafactor.update(params, grads, state,
                                                   leaves, hyper),
                          calls=2, replays=3)
    passes = kernel_split_ms(lambda: adafactor.update(
        params, grads, state, leaves, hyper), K11_PASSES, runs=3)
    row.update({f"{k.strip(':')}_ms": v for k, v in passes.items()})
    # Each tile pass against its own bytes: tile_stats reads g and p,
    # tile_u2 g, apply g and p and writes p.
    own = {"tile_stats": 4 * n, "tile_u2": 2 * n, "apply_update": 6 * n}
    for k, nbytes in own.items():
        row[f"{k}_own_bound_ms"] = bytes_ms(nbytes)
    row["plain_ms"] = device_ms(lambda: adafactor.update_reference(
        params, grads, state, leaves, hyper), calls=1, replays=2)
    row["bound_ms"] = bytes_ms(6 * n)
    torch.cuda.empty_cache()
    lib_params = [p.detach().clone().requires_grad_()
                  for p in params.values()]
    for leaf, g in zip(lib_params, grads.values()):
        leaf.grad = g
    opt = torch.optim.Adafactor(lib_params, lr=3e-4, weight_decay=0.1)
    row["library_ms"] = eager_ms(opt.step, iters=5, repeats=3)

    def share(k):
        t = passes.get(f"::{k}")
        return ("not measured" if t is None else
                f"{row[f'{k}_own_bound_ms'] / t:.0%} of its own bytes")

    log(f"K11 {len(params)} tensors in {blocks} blocks ({factored} "
        f"factored), {n / 1e6:.1f}M params (bf16 p and g; f32 moments in "
        f"the JAX leaves' shapes): params within {worst:.2f} bf16 ulp of "
        f"the plain update (max abs {abs_err:.3e}), moments {rel:.2e} "
        f"relative of the plain update in f64, its norm {nrel:.2e} relative "
        f"of K5's, two calls bitwise equal (clipped and not); kernel, norm "
        f"included, {row['ms']:.4f} ms (PR 14: K5's norm + K11 "
        f"{K11_PR14_MS}, tile passes {K11_PR14_TILE_MS}) (" + ", ".join(
            f"{k.strip(':')} {v:.4f}" for k, v in passes.items()
            if v is not None) + "; " + ", ".join(
            f"{k} {share(k)}" for k in own) + "; bytes in flight an SM in "
        f"tile_u2 {row['inflight_bytes_per_sm']}), plain "
        f"{row['plain_ms']:.4f}, torch.optim.Adafactor step "
        f"{row['library_ms']:.4f} (eager; its own eps, clip and relative "
        f"step: not the same function), bound {row['bound_ms']:.4f} "
        f"(bytes)")
    del params, grads, state, lib_params, opt
    torch.cuda.empty_cache()
    return row


# Mixtral-8x7B's MoE layer: 8 experts of width 4096, bf16 activations, at
# the served decode step (8 rows, capacity 4) and at a prefill group of
# 8 x 512 tokens (capacity 1280; group_size 8192 keeps it one group).
MOE_E, MOE_M = 8, 4096
MOE_CASES = (("decode", 8), ("prefill", 4096))


def moe_phase():
    """K12-K14 against their plain versions (ops/moe.py) at MOE_CASES'
    shapes, bf16 router logits N(0, 1) with expert 1 raised by 3 so that
    capacity drops choices: K12's integer outputs equal and its weights,
    slot flags and aux loss bitwise, K13 and K14 bitwise, each twice
    bitwise equal. Times each (CUDA-graph replays; cold over sets past
    twice the L2 where a call is smaller) and its plain version beside
    its byte bound (K12: logits read, maps written; K13: x read once,
    the buffers written; K14: the kept choices' rows of y read, the
    tokens written); no library call computes any of them."""
    from kubeflow_tpu_torch.ops import moe
    from kubeflow_tpu_torch.parallel.moe import Top2GateConfig

    gen = torch.Generator(device="cuda").manual_seed(12)
    cfg = Top2GateConfig(num_experts=MOE_E)
    rows = {"K12": {}, "K13": {}, "K14": {}}
    for case, T in MOE_CASES:
        C = cfg.capacity(T)
        S = MOE_E * C
        big = T > 8
        # bf16, as the router's product reaches K12 on the served path.
        logits = torch.randn(T, MOE_E, generator=gen, device="cuda")
        logits[:, 1] += 3.0
        logits = logits.bfloat16()
        r = moe.route(logits, 1, C, torch.bfloat16)
        _bitwise(f"K12 {case}", zip(r, moe.route_reference(
            logits, 1, C, torch.bfloat16)))
        _bitwise(f"K12 {case} twice", zip(r, moe.route(
            logits, 1, C, torch.bfloat16)))
        kept = int((r.dest1 < S).sum() + (r.dest2 < S).sum())
        if kept >= 2 * T:
            raise AssertionError(f"K12 {case}: no choice dropped")
        route_bytes = T * MOE_E * 2 + 16 * T + 6 * S + 4
        row = dict(max_abs_err=0.0, library_ms=None, bound_by="bytes",
                   bound_ms=bytes_ms(route_bytes), kept=kept, slots=S)
        row["ms"] = device_ms(lambda: moe.route(logits, 1, C,
                                                torch.bfloat16))
        row["plain_ms"] = device_ms(
            lambda: moe.route_reference(logits, 1, C, torch.bfloat16),
            calls=2, replays=3)
        rows["K12"][case] = row

        gather_bytes = T * MOE_M * 2 + 6 * S + S * MOE_M * 2
        n = sets_for(gather_bytes)
        xs = [torch.randn(T, MOE_M, generator=gen, device="cuda").bfloat16()
              for _ in range(n)]
        ein = moe.gather_rows(xs[0], r.slot_tok, r.slot_valid)
        _bitwise(f"K13 {case}", [
            (ein, moe.gather_rows_reference(xs[0], r.slot_tok,
                                            r.slot_valid)),
            (ein, moe.gather_rows(xs[0], r.slot_tok, r.slot_valid))])
        row = dict(max_abs_err=0.0, library_ms=None, bound_by="bytes",
                   bound_ms=bytes_ms(gather_bytes))
        row["ms"] = timed(lambda i: moe.gather_rows(xs[i], r.slot_tok,
                                                    r.slot_valid),
                          gather_bytes, big)
        row["plain_ms"] = device_ms(
            lambda: moe.gather_rows_reference(xs[0], r.slot_tok,
                                              r.slot_valid),
            calls=2, replays=3)
        rows["K13"][case] = row

        combine_bytes = kept * MOE_M * 2 + 16 * T + T * MOE_M * 2
        n = sets_for(S * MOE_M * 2)
        ys = [torch.randn(S, MOE_M, generator=gen, device="cuda").bfloat16()
              for _ in range(n)]
        out = moe.combine_rows(ys[0], r.g1, r.g2, r.dest1, r.dest2)
        _bitwise(f"K14 {case}", [
            (out, moe.combine_rows_reference(ys[0], r.g1, r.g2, r.dest1,
                                             r.dest2)),
            (out, moe.combine_rows(ys[0], r.g1, r.g2, r.dest1, r.dest2))])
        row = dict(max_abs_err=0.0, library_ms=None, bound_by="bytes",
                   bound_ms=bytes_ms(combine_bytes))
        row["ms"] = timed(lambda i: moe.combine_rows(ys[i], r.g1, r.g2,
                                                     r.dest1, r.dest2),
                          S * MOE_M * 2, big)
        row["plain_ms"] = device_ms(
            lambda: moe.combine_rows_reference(ys[0], r.g1, r.g2, r.dest1,
                                               r.dest2),
            calls=2, replays=3)
        rows["K14"][case] = row
        for tag in ("K12", "K13", "K14"):
            x = rows[tag][case]
            log(f"{tag} {case} (T={T}, E={MOE_E}, C={C}, M={MOE_M}, "
                f"{kept} of {2 * T} choices kept): bitwise, kernel "
                f"{x['ms']:.5f} ms, plain {x['plain_ms']:.5f}, bound "
                f"{x['bound_ms']:.6f} (bytes); library n/a (no single call)")
        del xs, ys, ein, out
        torch.cuda.empty_cache()
    return rows


def _bitwise(name: str, pairs) -> None:
    for a, b in pairs:
        if not torch.equal(a, b):
            diff = float((a.float() - b.float()).abs().max())
            raise AssertionError(f"{name}: not bitwise its plain version "
                                 f"(max diff {diff:.3e})")


def rope_strided_rows(gen) -> dict:
    """K7's strided mode: q and k read in place from the fused q/k/v
    projection [B, S, Hkv, G + 2, 128] (forward), dq and dk written into
    their slots of the fused gradient (backward), at the fused train
    step's [12, 2047, 8, 2 + 2] and llama3-8b's serving [8, 1, 8, 4 + 2]
    and [1, 512, 8, 4 + 2]: bitwise the plain version, two calls equal.
    Timed beside the byte bound; at the train shape also the copy of v
    into the contiguous tensor K1 reads."""
    from kubeflow_tpu_torch.ops import rope

    cos, sin = rope.rope_frequencies(128, 2048, theta=500000.0,
                                     device="cuda")
    out = {}
    for case, (b, s, hkv, g), train in (
            ("train", (TRAIN_BATCH, TRAIN_SEQ - 1, TRAIN_HKV, 2), True),
            ("decode", (8, 1, HKV, H // HKV), False),
            ("paged", (48, 1, HKV, H // HKV), False),
            ("prefill", (1, 512, HKV, H // HKV), False)):
        heads = hkv * (g + 1)                     # q's and k's
        call = 2 * b * s * heads * 128 * 2
        n = sets_for(call)
        qkvs = [torch.randn(b, s, hkv, g + 2, 128, generator=gen,
                            device="cuda").bfloat16() for _ in range(n)]
        pos = (torch.arange(s, device="cuda").expand(b, s) if train else
               torch.randint(0, 1024, (b, s), generator=gen, device="cuda"))
        qo = torch.empty(b, s, hkv * g, 128, device="cuda").bfloat16()
        ko = torch.empty(b, s, hkv, 128, device="cuda").bfloat16()

        def fwd(i, qo=qo, ko=ko, pos=pos):
            qs, ks = rope._fused_slots(qkvs[i])
            rope._launch(qs, ks, qo.view(qs.shape), ko.unsqueeze(3), cos,
                         sin, pos, inverse=False)
            return qo, ko

        def plain(x=qkvs[0], pos=pos, g=g):
            return (rope.rope_reference(x[..., :g, :].flatten(2, 3), cos,
                                        sin, positions=pos),
                    rope.rope_reference(x[..., g, :], cos, sin,
                                        positions=pos))

        got = [t.clone() for t in fwd(0)]
        want = plain()
        _bitwise(f"K7 strided {case}", zip(got + got,
                                           list(want) + list(fwd(0))))
        table = int(pos.clamp(0, 2047).unique().numel()) * 64 * 4 * 2
        row = dict(max_abs_err=0.0, bound_ms=bytes_ms(call + table
                                                      + pos.numel() * 8))
        row["ms"] = timed(fwd, call, train)
        row["plain_ms"] = device_ms(plain, calls=2 if train else 10,
                                    replays=3 if train else 5)
        if train:
            dq, dk = (torch.randn(t.shape, generator=gen,
                                  device="cuda").bfloat16() for t in got)
            dqkv = torch.empty_like(qkvs[0])
            dqs, dks = rope._fused_slots(dqkv)

            def bwd():
                rope._launch(dq.view(dqs.shape), dk.unsqueeze(3), dqs, dks,
                             cos, sin, pos, inverse=True)

            bwd()
            _bitwise("K7 strided backward", [
                (dqs.flatten(2, 3), rope.rope_reference(
                    dq, cos, sin, positions=pos, inverse=True)),
                (dks[..., 0, :], rope.rope_reference(
                    dk, cos, sin, positions=pos, inverse=True))])
            row["bwd_ms"] = device_ms(bwd, calls=2, replays=3)
            row["bwd_bound_ms"] = row["bound_ms"]
            row["v_copy_ms"] = device_ms(
                lambda: qkvs[0][..., g + 1, :].contiguous(), calls=2,
                replays=3)
            row["v_copy_bound_ms"] = bytes_ms(2 * b * s * hkv * 128 * 2)
            del dq, dk, dqkv
        out[f"strided_{case}"] = row
        log(f"K7 strided {case} qkv {list(qkvs[0].shape)} bf16: bitwise, "
            f"kernel {row['ms']:.4f} ms"
            + (f" (backward {row['bwd_ms']:.4f}; v's copy "
               f"{row['v_copy_ms']:.4f}, bound {row['v_copy_bound_ms']:.4f})"
               if train else "")
            + f", plain {row['plain_ms']:.4f}, library n/a, bound "
            f"{row['bound_ms']:.5f} (bytes)")
        del qkvs, got, want
    torch.cuda.empty_cache()
    return out


def rope_stage_rows(gen) -> dict:
    """K7's staged-decode mode (q rotated, k rotated into staging column
    ``stage_step``, v copied into it: one launch) at the 8-slot decode
    step ([8, 1, 32/8, 128], 8 staging rows) and the paged one's ([48, 1,
    32/8, 128], 32 rows), q/k/v apart and as the fused [B, 1, 8, 4 + 2,
    128] product read in place: bitwise the plain version (rope_reference
    on q and k, then the two slice writes), the staging tensors compared
    whole (only the column changes), two calls equal. Timed cold (calls
    rotating over sets past twice the L2) beside what it replaces, in the
    same call: K7 on q and k, then the two staging copies as the parent's
    step made them. Bound: bytes (q, k, v read, q' and the two columns
    written, the positions and the rows of the tables they select)."""
    from kubeflow_tpu_torch.ops import rope

    cos, sin = rope.rope_frequencies(128, 2048, theta=500000.0,
                                     device="cuda")
    out = {}
    for case, b, C in (("decode", 8, 8), ("paged", 48, SP_CHUNK)):
        for fused in (False, True):
            name = f"stage_{case}" + ("_fused" if fused else "")
            step = C - 1 if fused else C // 2
            call = 2 * b * (H + 2 * HKV) * 128 * 2
            n = sets_for(call)
            qkvs = [torch.randn(b, 1, HKV, H // HKV + 2, 128, generator=gen,
                                device="cuda").bfloat16() for _ in range(n)]
            if fused:
                ins = [(x,) for x in qkvs]
            else:
                ins = [(x[..., :H // HKV, :].reshape(b, 1, H, 128)
                        .contiguous(), x[..., -2, :].contiguous(),
                        x[..., -1, :].contiguous()) for x in qkvs]
            pos = torch.randint(0, 1024, (b, 1), generator=gen,
                                device="cuda")
            stage = [torch.randn(b, C, HKV, 128, generator=gen,
                                 device="cuda").bfloat16() for _ in range(2)]
            fn = rope.rope_stage_fused if fused else rope.rope_stage

            def kernel(i, fn=fn, ins=ins, pos=pos, stage=stage, step=step):
                return fn(*ins[i], cos, sin, pos, *stage, step)

            def apart(i, ins=ins, pos=pos, stage=stage, step=step,
                      fused=fused):
                # What the staged step ran before: K7 on q and k, then the
                # two staging copies.
                if fused:
                    q, k, v = rope._rotate_fused(ins[i][0], cos, sin, pos)                         + (ins[i][0][..., -1, :],)
                else:
                    q, k, v = ins[i]
                    q, k = rope._kernel(q, k, cos, sin, pos, False)
                stage[0][:, step:step + 1] = k
                stage[1][:, step:step + 1] = v
                return q

            def plain(ins=ins, pos=pos, stage=stage, step=step):
                sk, sv = (t.clone() for t in stage)
                if len(ins[0]) == 1:
                    x = ins[0][0]
                    args = (x[..., :H // HKV, :].reshape(b, 1, H, 128),
                            x[..., -2, :], x[..., -1, :])
                else:
                    args = ins[0]
                return (rope.rope_stage_reference(*args, cos, sin, pos, sk,
                                                  sv, step), sk, sv)

            before = [t.clone() for t in stage]
            with torch.no_grad():
                want = plain()
                got = kernel(0)
                _bitwise(f"K7 {name}", [(got, want[0]), (stage[0], want[1]),
                                        (stage[1], want[2]),
                                        (kernel(0), got)])
                others = [c for c in range(C) if c != step]
                _bitwise(f"K7 {name} (the other staging columns)",
                         [(stage[0][:, others], before[0][:, others]),
                          (stage[1][:, others], before[1][:, others])])
                table = int(pos.unique().numel()) * 64 * 4 * 2
                row = dict(max_abs_err=0.0, library_ms=None, rows=b,
                           bound_ms=bytes_ms(call + table + b * 8))
                row["ms"] = timed(kernel, call)
                row["apart_ms"] = timed(apart, call)
                row["ms"] = min(row["ms"], timed(kernel, call))
                row["plain_ms"] = device_ms(lambda: plain()[0])
            out[name] = row
            log(f"K7 {name} [{b}, 1, {H}/{HKV}/{HKV}, 128], {C} staging "
                f"rows, column {step}: bitwise (q and both staging tensors "
                f"whole), kernel {row['ms'] * 1e3:.3f} us (one launch) "
                f"against {row['apart_ms'] * 1e3:.3f} us for K7 then the two "
                f"copies; plain {row['plain_ms']:.4f} ms; library n/a; bound "
                f"{row['bound_ms']:.5f} ms (bytes)")
            del qkvs, ins, stage, before, want, got
    torch.cuda.empty_cache()
    return out


def swiglu_rows(gen) -> dict:
    """K9 against its plain version, bitwise, with gate and up as two
    tensors and as the halves of one fused [rows, 2, F] product: at the
    train step's [24564, 5632] forward and backward, and at llama3-8b's
    serving [8, 14336] and [512, 14336] forward. Timed (cold over sets
    larger than twice the L2 where a call is smaller) beside the byte
    bound; no library call computes it."""
    from kubeflow_tpu_torch.ops import swiglu as sw

    out = {}
    for case, rows_, F_, train in (("train", TRAIN_ROWS, 5632, True),
                                   ("decode", 8, 14336, False),
                                   ("paged", 48, 14336, False),
                                   ("prefill", 512, 14336, False)):
        for fused in (False, True):
            name = case + ("_fused" if fused else "")
            call = 3 * rows_ * F_ * 2
            n = sets_for(call)
            gus = [(torch.randn(rows_, 2, F_, generator=gen, device="cuda")
                    * 3).bfloat16() for _ in range(n)]
            ins = [(gu[:, 0], gu[:, 1]) if fused else
                   (gu[:, 0].contiguous(), gu[:, 1].contiguous())
                   for gu in gus]
            gate, up = ins[0]
            h = sw._fwd_kernel(gate, up)
            _bitwise(f"K9 {name}", [(h, sw.swiglu_reference(gate, up)),
                                    (h, sw._fwd_kernel(gate, up))])
            row = dict(max_abs_err=0.0, library_ms=None,
                       bound_ms=bytes_ms(call))
            row["ms"] = timed(lambda i: sw._fwd_kernel(*ins[i]), call, train)
            row["plain_ms"] = device_ms(
                lambda: sw.swiglu_reference(gate, up),
                calls=2 if train else 10, replays=3 if train else 5)
            if train:
                dh = torch.randn(rows_, F_, generator=gen,
                                 device="cuda").bfloat16()
                if fused:
                    dgu = torch.empty_like(gus[0])
                    dg, du = dgu[:, 0], dgu[:, 1]
                else:
                    dg, du = torch.empty_like(gate), torch.empty_like(up)
                sw._bwd_kernel(gate, up, dh, dg, du)
                want = sw.swiglu_backward_reference(gate, up, dh)
                _bitwise(f"K9 {name} backward", zip((dg, du), want))
                del want
                row["bwd_ms"] = device_ms(
                    lambda: sw._bwd_kernel(gate, up, dh, dg, du), calls=2,
                    replays=3)
                row["bwd_plain_ms"] = device_ms(
                    lambda: sw.swiglu_backward_reference(gate, up, dh),
                    calls=1, replays=2)
                row["bwd_bound_ms"] = bytes_ms(5 * rows_ * F_ * 2)
                del dh, dg, du
            out[name] = row
            log(f"K9 {name} [{rows_}, {F_}] bf16: bitwise, kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                + (f"; backward kernel {row['bwd_ms']:.4f}, plain "
                   f"{row['bwd_plain_ms']:.4f}, bound "
                   f"{row['bwd_bound_ms']:.4f}" if train else "")
                + f"; library n/a (no single call); bound "
                f"{row['bound_ms']:.5f} (bytes)")
            del gus, ins, gate, up, h
            torch.cuda.empty_cache()
    return out


def add_norm_rows(gen) -> dict:
    """K10 against its plain version: the sum bitwise, y within one bf16
    ulp, two calls bitwise equal; at the train step's [24564, 2048] forward
    and backward and at llama3-8b's serving [8, 4096] (the 8-slot decode),
    [48, 4096] (the paged step's 48 slots) and [4096, 4096] forward. Up to
    ROWS_MAX rows through the rows kernel, held and timed (a launch, cold)
    beside the block-a-row kernel at the same rows. The backward's norm part (dx with no residual gradient) and
    dw within one bf16 ulp, as K6's; with the residual's gradient dr, dx
    bitwise dr + that part, rounded as the plain add rounds it (one ulp of
    the norm part is many of a sum that cancels, so dx itself is held to
    the part it adds). Timed beside the byte bound; no library call
    computes it."""
    from kubeflow_tpu_torch.ops import norms

    out = {}
    for case, rows_, E, train in (("train", TRAIN_ROWS, 2048, True),
                                  ("decode", 8, SERVE_E, False),
                                  ("paged", 48, SERVE_E, False),
                                  ("prefill", 4096, SERVE_E, False)):
        call = 4 * rows_ * E * 2
        n = sets_for(call)
        xs = [torch.randn(rows_, E, generator=gen, device="cuda").bfloat16()
              for _ in range(n)]
        hs = [torch.randn(rows_, E, generator=gen, device="cuda").bfloat16()
              for _ in range(n)]
        w = (1 + 0.1 * torch.randn(E, generator=gen, device="cuda")
             ).bfloat16()
        x, h = xs[0], hs[0]
        small = rows_ <= norms.ROWS_MAX
        want_r, want_y, _ = norms.add_rms_norm_reference(x, h, w, eps=1e-6)
        rows_before = norms.add_rms_norm.rows_launches
        r, y, rstd = norms._add_fwd_kernel(x, h, w, 1e-6)
        err = ulps(y, want_y)
        again = norms._add_fwd_kernel(x, h, w, 1e-6)
        if norms.add_rms_norm.rows_launches - rows_before != 2 * small:
            raise AssertionError(f"K10 {case}: the rows kernel ran "
                                 f"{norms.add_rms_norm.rows_launches - rows_before}"
                                 f" times of 2 at {rows_} rows (ROWS_MAX "
                                 f"{norms.ROWS_MAX})")
        if not torch.equal(r, want_r) or err > 1 or not (
                torch.equal(again[0], r) and torch.equal(again[1], y)):
            raise AssertionError(f"K10 {case} forward: sum bitwise "
                                 f"{torch.equal(r, want_r)}, y {err:.2f} ulp,"
                                 f" or two calls differ")
        row = dict(max_abs_err=float((y.float() - want_y.float()).abs().max()),
                   ulps=err, library_ms=None, rows=rows_,
                   bound_ms=bytes_ms(call + 2 * E + 4 * rows_))
        row["ms"] = timed(lambda i: norms._add_fwd_kernel(xs[i], hs[i], w,
                                                          1e-6), call, train)
        if small:                       # the block-a-row kernel beside it
            row["block_ms"] = timed(lambda i: norms._add_fwd_kernel(
                xs[i], hs[i], w, 1e-6, by_rows=False), call, train)
        row["plain_ms"] = device_ms(
            lambda: norms.add_rms_norm_reference(x, h, w, eps=1e-6),
            calls=2 if train else 10, replays=3 if train else 5)
        if train:
            dy, dr = (torch.randn(rows_, E, generator=gen,
                                  device="cuda").bfloat16() for _ in range(2))
            dxn, dwn = norms._add_bwd_kernel(r, w, dy, rstd, None)
            pdx, pdw = norms.add_rms_norm_backward_reference(r, w, dy, rstd,
                                                             None)
            berr = max(ulps(dxn, pdx), ulps(dwn, pdw))
            dx, dw = norms._add_bwd_kernel(r, w, dy, rstd, dr)
            again = norms._add_bwd_kernel(r, w, dy, rstd, dr)
            if berr > 1 or not (torch.equal(dx, dr + dxn)
                                and torch.equal(dw, dwn)
                                and torch.equal(again[0], dx)
                                and torch.equal(again[1], dw)):
                raise AssertionError(f"K10 {case} backward: {berr:.2f} ulp, "
                                     "dx not dr + its norm part, or two "
                                     "calls differ")
            row["bwd_ulps"] = berr
            row["bwd_ms"] = device_ms(
                lambda: norms._add_bwd_kernel(r, w, dy, rstd, dr), calls=2,
                replays=3)
            row["bwd_plain_ms"] = device_ms(
                lambda: norms.add_rms_norm_backward_reference(r, w, dy, rstd,
                                                              dr),
                calls=2, replays=3)
            row["bwd_bound_ms"] = bytes_ms(4 * rows_ * E * 2 + 4 * E
                                           + 4 * rows_)
            del dy, dr, dx, dw, dxn, dwn, pdx, pdw
        out[case] = row
        log(f"K10 {case} [{rows_}, {E}] bf16: sum bitwise, y {err:.2f} ulp, "
            f"kernel {row['ms']:.4f} ms"
            + (f" (rows kernel, {row['ms'] * 1e3:.3f} us a launch; a block "
               f"a row {row['block_ms'] * 1e3:.3f} us; PR 14: 3.5 us at 8 "
               "rows)" if small else "")
            + f", plain {row['plain_ms']:.4f}"
            + (f"; backward {row['bwd_ulps']:.2f} ulp, kernel "
               f"{row['bwd_ms']:.4f}, plain {row['bwd_plain_ms']:.4f}, "
               f"bound {row['bwd_bound_ms']:.4f}" if train else "")
            + f"; library n/a (no single call); bound {row['bound_ms']:.5f}"
            " (bytes)")
        del xs, hs, x, h, r, y, want_r, want_y, again
        torch.cuda.empty_cache()
    return out


#: The served path's element-wise launch counters, in check_elementwise's
#: order: K6, K7 (its staged mode included), K7's staged mode, K9, K4's
#: SwiGLU epilogue, K10.
SERVING_COUNTERS = ("K6", "K7", "K7 staged", "K9", "K4 epilogue", "K10")


def serving_counters():
    """(function, counter name) of SERVING_COUNTERS, in that order."""
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear
    from kubeflow_tpu_torch.ops.norms import add_rms_norm, rms_norm
    from kubeflow_tpu_torch.ops.rope import apply_rope
    from kubeflow_tpu_torch.ops.swiglu import swiglu

    return ((rms_norm, "fwd_launches"), (apply_rope, "fwd_launches"),
            (apply_rope, "stage_launches"), (swiglu, "fwd_launches"),
            (int8_linear, "swiglu_launches"), (add_rms_norm, "fwd_launches"))


def zero_serving_counters() -> None:
    for fn, name in serving_counters():
        setattr(fn, name, 0)


def read_serving_counters() -> list:
    return [getattr(fn, name) for fn, name in serving_counters()]


def epilogue_engine(engine) -> bool:
    """Whether ``engine``'s decode steps take K4's SwiGLU epilogue: int8
    weights and at most DECODE_MAX_ROWS slots (the decode kernel's rows);
    the paged phase's 48 slots, and bf16 weights, take K9."""
    from kubeflow_tpu_torch.ops.int8_linear import DECODE_MAX_ROWS

    return bool(engine.quantized) and engine.cfg.max_batch <= DECODE_MAX_ROWS


def check_elementwise(counts, layers: int, passes: int, decode_steps: int,
                      epilogue: bool) -> None:
    """K6, K7, K9 and K10 in the served path: every forward pass of the
    model (a decode step, a prefill, an extend chunk; graph replays
    counted) runs the first layer's input norm (K6) and RoPE (K7) once a
    layer, and the add + norm (K10) twice a layer: after the attention,
    and from each layer into the next one's input norm or the final norm.
    Every decode step (all staged) runs K7's staged mode, which writes the
    staging rows, once a layer. SwiGLU runs once a layer: as K4's
    epilogue at ``epilogue`` engines' decode steps, else as K9."""
    ep = layers * decode_steps if epilogue else 0
    want = [passes, layers * passes, layers * decode_steps,
            layers * passes - ep, ep, 2 * layers * passes]
    if list(counts) != want:
        raise AssertionError(
            f"{', '.join(SERVING_COUNTERS)} launches {list(counts)}: want "
            f"{want} ({passes} forward passes of {layers} layers, "
            f"{decode_steps} of them decode steps"
            + (", K4's epilogue at each" if epilogue else "") + ")")


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


def extend_timings(engine, tag, starts, reps=7):
    """Chunked-prefill chunk ms on an idle ``engine``, eager (the engine's
    graphs off: the same step op by op) against graphed (the captured
    graph's replay), each chunk timed between device synchronisations,
    the median of ``reps`` after one untimed: warm (slot 1 at the last of
    ``starts``, again and again) and cold (the L2 flushed before each
    chunk, over slots 0-3 and ``starts`` in turn). A paged engine's slots
    0-3 hold distinct pages for the run and scratch-filled tables again
    after it."""
    C = engine.cfg.prefill_buckets[-1]
    V = engine.model.cfg.vocab_size
    rs = np.random.RandomState(3)
    samp = np.zeros((1, 3), np.float32)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    if engine._paged:
        nb = engine._max_table_blocks
        pages = np.random.RandomState(4).permutation(engine.cfg.kv_blocks)
        engine._block_tables[:4] = pages[:4 * nb].reshape(4, nb)
        engine._tables_dirty = True
    out, was = {}, engine._graphed
    try:
        for graphed in (False, True):
            engine._graphed = graphed
            for kind in ("warm", "cold"):
                times = []
                for r in range(reps + 1):
                    slot, start = ((r % 4, starts[r % len(starts)])
                                   if kind == "cold" else (1, starts[-1]))
                    tokens = rs.randint(0, V, (1, C))
                    if kind == "cold":
                        flush.zero_()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine._run_extend(tokens, start, C, slot, samp)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                key = f"{'graphed' if graphed else 'eager'}_{kind}_ms"
                out[key] = float(np.median(times[1:]))
        # Beside it: the grouped prefill of C tokens on one slot (its
        # graph), the same model work in prefill mode; and one graphed
        # chunk under the profiler: where its time goes.
        tokens = rs.randint(0, V, (1, C))
        args = (tokens, np.full((1,), C), np.ones((1,), np.int64), samp)
        if engine._paged:
            args += (engine._block_tables[1:2], np.zeros((1,), np.int64))
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine._run_prefill(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["prefill_graphed_ms"] = float(np.median(times[1:]))
        wall, busy, kernels = profiled(
            lambda: engine._run_extend(tokens, starts[-1], C, 1, samp))
    finally:
        engine._graphed = was
        if engine._paged:
            engine._block_tables[:4] = engine._scratch_block
            engine._tables_dirty = True
    del flush
    out.update(profiled_wall_ms=wall, profiled_busy_ms=busy)
    log(f"{tag}: extend chunk (C={C}, max_len {engine.cfg.max_len}, starts "
        f"{list(starts)}), median of {reps}, device-synchronised: eager "
        f"warm {out['eager_warm_ms']:.3f} ms, cold {out['eager_cold_ms']:.3f}"
        f" ms; graphed warm {out['graphed_warm_ms']:.3f} ms, cold "
        f"{out['graphed_cold_ms']:.3f} ms (x"
        f"{out['eager_warm_ms'] / out['graphed_warm_ms']:.2f} warm); the "
        f"grouped prefill of {C} tokens (graph) "
        f"{out['prefill_graphed_ms']:.3f} ms; one graphed chunk profiled: "
        f"wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"  {e.key[:70]}: {e.device_time_total / 1e3:.3f} ms over "
            f"{e.count} calls")
    return out


def word_tokenizer(vocab: int, directory: str):
    """A WordLevel tokenizer over ``vocab`` ids (id i is "w<i>", 0 the
    unknown word), split on whitespace, saved as ``directory``/
    tokenizer.json; None where the ``tokenizers`` package does not
    import."""
    try:
        from tokenizers import Tokenizer, pre_tokenizers
        from tokenizers import models as tok_models
    except ImportError:
        return None
    words = {"<unk>": 0, **{f"w{i}": i for i in range(1, vocab)}}
    tok = Tokenizer(tok_models.WordLevel(words, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(directory, "tokenizer.json"))
    return tok


def text_check(base: str, tok, tag: str) -> None:
    """A ``{"text": ...}`` request, plain and streamed, through the
    server that loaded ``tok``: the prompt is the text's words, and the
    reply's text (the stream's last event's) decodes its tokens."""
    words = " ".join(f"w{i}" for i in range(7, 7 * 41, 7))      # 40 words
    for stream in (False, True):
        out = post(base, {"text": words, "max_new_tokens": 8,
                          "stream": stream})
        if (out["prompt_len"] != 40 or len(out["tokens"]) != 8
                or out.get("text") != tok.decode(out["tokens"])):
            raise AssertionError(f"text request (stream {stream}): {out}")
    log(f"{tag}: text surface (KFTPU_SERVING_TOKENIZER): a 40-word text "
        f"served plain and streamed, text = decode(tokens): "
        f"{out['text'][:40]!r}...")


def serve_phase(quantize_kv: str = "", quantize: str = "",
                text: bool = False):
    """One HTTP burst against the llama3-8b server; ``quantize_kv`` "int8"
    serves from the int8 KV cache, ``quantize`` "int8" with int8 weights;
    ``text`` loads a tokenizer (where the ``tokenizers`` package imports)
    and serves a text request after the bursts. Returns the burst's
    figures."""
    import itertools
    import tempfile

    from kubeflow_tpu_torch.models.llama import int8_launches_per_pass
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear
    from kubeflow_tpu_torch.serving.server import build_server, env_config

    os.environ.update({
        "KFTPU_SERVING_MODEL": "llama3-8b", "KFTPU_SERVING_MAX_BATCH": "8",
        "KFTPU_SERVING_MAX_LEN": "1024", "KFTPU_SERVING_DECODE_CHUNK": "8",
        "KFTPU_SERVING_HOST": "127.0.0.1", "KFTPU_SERVING_PORT": "0",
        "KFTPU_SERVING_QUANTIZE_KV": quantize_kv,
        "KFTPU_SERVING_QUANTIZE": quantize,
    })
    os.environ.pop("KFTPU_PLATFORM", None)          # cuda
    tag = (f"serve [{quantize_kv or 'bf16'} KV cache"
           + (f", {quantize} weights]" if quantize else "]"))
    tok, tok_dir = None, tempfile.mkdtemp(prefix="kftpu-smoke-tok-")
    if text:
        tok = word_tokenizer(128256, tok_dir)
        if tok is None:
            log(f"{tag}: text surface not served: the tokenizers package "
                "does not import on this machine (the CPU tests hold it)")
    os.environ["KFTPU_SERVING_TOKENIZER"] = tok_dir if tok else ""
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    try:
        server = build_server(env_config())
    finally:
        shutil.rmtree(tok_dir, ignore_errors=True)
    build_peak = torch.cuda.max_memory_allocated()
    engine = server.engine
    model = engine.model
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       itertools.chain(model.parameters(), model.buffers()))
    cache_bytes = sum(t.numel() * t.element_size()
                      for layer in engine._cache for t in layer.values())
    log(f"{tag}: llama3-8b built in {time.time() - t0:.1f} s, weights "
        f"{weight_bytes / 1e9:.2f} GB ({len(engine.quantized)} int8 "
        f"projections), KV cache {cache_bytes / 1e9:.3f} GB (staging "
        f"{model.cfg.decode_staging} rows); peak device memory while "
        f"building {build_peak / 1e9:.2f} GB")
    t0 = time.time()
    engine.warmup(700)
    log(f"{tag}: warmup (bucket 512's greedy prefill graphs, the "
        f"chunked-prefill extend's greedy graph, the decode chunk's graph "
        f"of each sampling variant) {time.time() - t0:.1f} s")
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
    layers = model.cfg.num_layers
    chunk = engine.cfg.decode_chunk
    # K4 per forward pass: one launch for each group the model forms (q/k/v,
    # gate/up), one for each other int8 projection and the lm_head.
    per_pass = int8_launches_per_pass(model)

    def burst(name):
        """All requests at once; checks the tokens and the launch counts
        (graph replays count their captured launches) of this burst."""
        outs = [None] * len(bodies)
        errors = []

        def client(i):
            try:
                outs[i] = post(base, bodies[i])
            except Exception as e:  # noqa: BLE001 — reported, then fail
                errors.append(f"request {i}: {e!r}")

        torch.cuda.reset_peak_memory_stats()
        flash_attention.fwd_launches = decode_attention.launches = 0
        int8_linear.launches = 0
        zero_serving_counters()
        engine.prefill_dispatches = engine.extend_dispatches = 0
        engine.decode_dispatches = 0
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.time() - t0
        k1, k3 = flash_attention.fwd_launches, decode_attention.launches
        k4 = int8_linear.launches
        counts = read_serving_counters()
        k6, k7, k7s, k9, k4e, k10 = counts
        prefills, extends, decodes = (engine.prefill_dispatches,
                                      engine.extend_dispatches,
                                      engine.decode_dispatches)
        peak = torch.cuda.max_memory_allocated()      # the burst's own
        if errors or any(o is None for o in outs):
            raise RuntimeError(f"serve failed: {errors}")
        for body, out in zip(bodies, outs):
            toks = out["tokens"]
            if len(toks) != new or not all(0 <= t < V for t in toks):
                raise AssertionError(f"bad tokens for a "
                                     f"{len(body['tokens'])}-token prompt: "
                                     f"{toks}")
        if prefills < 1 or k1 != layers * (prefills + extends):
            raise AssertionError(f"K1 launches {k1} != {layers} x "
                                 f"({prefills} prefill + {extends} extend "
                                 "dispatches)")
        if decodes < 1 or k3 != layers * chunk * decodes:
            raise AssertionError(f"K3 launches {k3} != {layers} x {chunk} "
                                 f"steps x {decodes} decode dispatches")
        if k4 != per_pass * (chunk * decodes + prefills + extends):
            raise AssertionError(
                f"K4 launches {k4} != {per_pass} x ({chunk} steps x "
                f"{decodes} decode + {prefills} prefill + {extends} extend "
                "dispatches)")
        check_elementwise(counts, layers, chunk * decodes + prefills + extends,
                          chunk * decodes, epilogue_engine(engine))
        if extends and ("extend", 512, "greedy") not in engine._graphs:
            raise AssertionError("the chunked prefill ran without its graph")
        generated = sum(len(o["tokens"]) for o in outs)
        ttft_p50 = float(np.median([o["ttft_s"] for o in outs]))
        ttft_long = outs[-1]["ttft_s"]                  # the 700-token one
        log(f"{tag} {name} burst: {len(outs)} requests, {generated} tokens "
            f"in {wall:.2f} s = {generated / wall:.1f} tok/s, p50 TTFT "
            f"{ttft_p50 * 1e3:.1f} ms (the 700-token request's "
            f"{ttft_long * 1e3:.1f} ms), {prefills} prefill + {extends} "
            f"extend + {decodes} decode dispatches, K1 launches {k1}, K3 "
            f"launches {k3}, K4 launches {k4} ({k4e} with the SwiGLU "
            f"epilogue), K6 launches {k6}, K7 launches {k7} ({k7s} staged), "
            f"K9 launches {k9}, K10 launches {k10}, peak device memory "
            f"{peak / 1e9:.2f} GB; {len(engine._graphs)} graphs so far; "
            "TTFT ms by prompt length: " + ", ".join(
                f"{len(b['tokens'])}: {o['ttft_s'] * 1e3:.1f}"
                for b, o in zip(bodies, outs)))
        return dict(outs=outs, k1=k1, k3=k3, k4=k4, k4e=k4e, k6=k6, k7=k7,
                    k7s=k7s, k9=k9, k10=k10, tok_s=generated / wall,
                    ttft_p50=ttft_p50, ttft_long=ttft_long, peak=peak)

    try:
        # The first burst after warmup captures the graphs its new shapes
        # need; the second finds them.
        cold = burst("cold")
        warm = burst("warm")
        if tok is not None:
            text_check(base, tok, tag)
    finally:
        server.stop()
    outs = cold.pop("outs")
    warm.pop("outs")
    extend = extend_timings(engine, tag, (0, 188))
    check_model = model
    if engine.quantized:
        # The re-forwards run on the dequantized bf16 weights (Dense
        # projections through cuBLAS), the function K4 computes.
        from kubeflow_tpu_torch.models.llama import (
            Llama,
            dequantized_state_dict,
        )

        with torch.device("meta"):
            check_model = Llama(model.cfg)
        check_model.load_state_dict(dequantized_state_dict(model),
                                    assign=True)
    gaps, bounds = greedy_check(check_model, [bodies[2], bodies[6]],
                                [outs[2], outs[6]],
                                kv_int8=quantize_kv == "int8")
    del check_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag}: graphs {sorted(engine._graphs)}; weights "
        f"{weight_bytes / 1e9:.2f} GB; greedy f32 re-forward: {len(gaps)} "
        f"tokens, {sum(g == 0 for g in gaps)} exact, max gap "
        f"{max(gaps):.4f}, bounds (2 x bf16 noise) "
        f"{min(bounds):.4f}-{max(bounds):.4f}")
    chunk_stats = decode_breakdown(engine, rs)
    return dict(cold, warm=warm, weight_bytes=weight_bytes,
                build_peak=build_peak, extend=extend, **chunk_stats)


# The paged serve phase: llama3-8b as `bench.py serving8b --paged` builds
# it (int8 weights, int8 KV cache, staged decode in chunks of 32, 48 slots,
# max_len 512, 16-row blocks, a pool sized to demand), 96 requests of
# 128-token prompts and 128 new tokens, greedy.
SP_BATCH, SP_MAX_LEN, SP_BS, SP_CHUNK = 48, 512, 16, 32
SP_PROMPT, SP_GEN, SP_REQUESTS, SP_SHARED = 128, 128, 96, 64
SP_BLOCKS = SP_BATCH * (-(-(SP_PROMPT + SP_GEN) // SP_BS) + 1)      # 816
# Burst (b)'s retried requests: request i + 1 repeats request i's prompt,
# cut to 120 tokens (a partial last page, which the pair shares and the
# first decode write forks).
SP_PAIRS, SP_PAIR_LEN = (10, 30, 60, 80), 120
# Burst (c): prompts past the bucket (chunked prefill: chunks at 0, 128
# and 172, the last slid back); request 5 repeats request 4's head (ten
# whole pages, so its chunks write from position 160 on).
SP_LONG, SP_LONG_REQUESTS, SP_LONG_HEAD, SP_LONG_GEN = 300, 8, 160, 32


def paged_prompts(vocab: int):
    """Burst (a): 96 random 128-token prompts; burst (b): the same count
    opening with one 64-token head (`--shared-prefix-len 64`), with the
    pairs of SP_PAIRS; burst (c): 8 prompts of 300 tokens, request 5
    opening with request 4's first 160. From seed 0."""
    rng = np.random.default_rng(0)
    plain = [rng.integers(1, vocab, SP_PROMPT).tolist()
             for _ in range(SP_REQUESTS)]
    head = rng.integers(1, vocab, SP_SHARED).tolist()
    shared = [head + rng.integers(1, vocab, SP_PROMPT - SP_SHARED).tolist()
              for _ in range(SP_REQUESTS)]
    for i in SP_PAIRS:
        shared[i] = shared[i][:SP_PAIR_LEN]
        shared[i + 1] = list(shared[i])
    long = [rng.integers(1, vocab, SP_LONG).tolist()
            for _ in range(SP_LONG_REQUESTS)]
    long[5][:SP_LONG_HEAD] = long[4][:SP_LONG_HEAD]
    return plain, shared, long


def paged_engine(paged: bool):
    """The llama3-8b engine of the paged serve phase (``paged`` False: the
    same configuration over the dense cache), random weights made on the
    card from seed 0."""
    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    pool = ({"paged_kv_blocks": SP_BLOCKS, "paged_kv_block_size": SP_BS}
            if paged else {})
    cfg = LlamaConfig.llama3_8b(
        max_seq_len=SP_MAX_LEN, param_dtype="bfloat16", scan_layers=False,
        remat=False, kv_cache_dtype="int8", decode_staging=SP_CHUNK, **pool)
    with torch.device("cuda"):
        model = Llama(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return ServingEngine(model, ServingConfig(
        max_batch=SP_BATCH, max_len=SP_MAX_LEN, decode_chunk=SP_CHUNK,
        quantize="int8", param_dtype="bfloat16", prefill_buckets=(128,),
        kv_blocks=SP_BLOCKS, kv_block_size=SP_BS),
        device="cuda", registry=MetricsRegistry())


def paged_burst(engine, name, prompts, sharers=None, new=SP_GEN):
    """All ``prompts`` submitted at once, ``new`` tokens each, then
    ``run()`` to the drain (as the bench drives it); launch counts zeroed
    just before and read just after, and checked (K1 and K4 once per
    prefill and per chunked-prefill chunk); conservation checked after
    the drain."""
    from kubeflow_tpu_torch.models.llama import int8_launches_per_pass
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    blocks = engine.blocks
    refs0, forks0 = blocks.shared_refs_total, blocks.cow_copies_total
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.fwd_launches = decode_attention.launches = 0
    int8_linear.launches = 0
    zero_serving_counters()
    engine.prefill_dispatches = engine.extend_dispatches = 0
    engine.decode_dispatches = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k3 = flash_attention.fwd_launches, decode_attention.launches
    k4 = int8_linear.launches
    counts = read_serving_counters()
    k6, k7, k7s, k9, _, k10 = counts
    peak = torch.cuda.max_memory_allocated()
    res = [engine.result(r) for r in rids]
    V = engine.model.cfg.vocab_size
    if any(r is None or len(r.tokens) != new
           or not all(0 <= t < V for t in r.tokens) for r in res):
        raise AssertionError(f"{name}: a request lacks its {new} tokens")
    layers = engine.model.cfg.num_layers
    prefills, decodes = engine.prefill_dispatches, engine.decode_dispatches
    extends = engine.extend_dispatches
    if k1 != layers * (prefills + extends):
        raise AssertionError(f"{name}: K1 launches {k1} != {layers} x "
                             f"({prefills} prefills + {extends} extends)")
    if decodes < 1 or k3 != layers * SP_CHUNK * decodes:
        raise AssertionError(f"{name}: K3 launches {k3} != {layers} x "
                             f"{SP_CHUNK} x {decodes} decode dispatches")
    per_pass = int8_launches_per_pass(engine.model)
    if k4 != per_pass * (SP_CHUNK * decodes + prefills + extends):
        raise AssertionError(f"{name}: K4 launches {k4} != {per_pass} x "
                             f"({SP_CHUNK} x {decodes} + {prefills} + "
                             f"{extends})")
    check_elementwise(counts, layers, SP_CHUNK * decodes + prefills + extends,
                      SP_CHUNK * decodes, epilogue_engine(engine))
    if extends and ("extend", SP_PROMPT, "greedy") not in engine._graphs:
        raise AssertionError(f"{name}: the chunked prefill ran without its "
                             "graph")
    blocks.check_conservation()
    if blocks.blocks_live:
        raise AssertionError(f"{name}: {blocks.blocks_live} blocks live "
                             "after the drain")
    out = dict(tokens=[r.tokens for r in res], k1=k1, k3=k3, k4=k4, k6=k6,
               k7=k7, k7s=k7s, k9=k9, k10=k10,
               tok_s=new * len(res) / wall,
               ttft_p50=float(np.median([r.ttft_s for r in res])),
               peak=peak, prefills=prefills, decodes=decodes,
               extends=extends,
               shared_refs=blocks.shared_refs_total - refs0,
               cow_copies=blocks.cow_copies_total - forks0,
               high_water=blocks.high_water_blocks)
    if sharers is not None:
        out["sharers"] = {i for i, r in enumerate(rids) if r in sharers}
    log(f"{name}: {len(res)} requests, {new * len(res)} tokens in "
        f"{wall:.2f} s = {out['tok_s']:.1f} tok/s, p50 TTFT "
        f"{out['ttft_p50'] * 1e3:.1f} ms, {prefills} prefill + {extends} "
        f"extend + {decodes} "
        f"decode dispatches, K1 {k1}, K3 {k3}, K4 {k4} launches, peak device "
        f"memory {peak / 1e9:.2f} GB, shared block references "
        f"{out['shared_refs']}, COW copies {out['cow_copies']}, blocks high "
        f"water {out['high_water']}; conservation clean")
    return out


def note_sharers(engine) -> set:
    """The request ids the paged ``engine`` admits onto shared pages, from
    now on: its admission wrapped (an instance attribute; delete it to
    unwrap)."""
    sharers = set()
    admit = engine._admit_paged

    def admit_noting(slot, req, demand):
        before = engine.blocks.shared_refs_total
        ok = admit(slot, req, demand)
        if ok and engine.blocks.shared_refs_total > before:
            sharers.add(req.request_id)
        return ok

    engine._admit_paged = admit_noting
    return sharers


def prefix_rows_agree(model, prompt):
    """Whether a prompt's cache rows (every layer's int8 k/v and scales)
    come out bitwise the same from a prefill group of 1 and one of the
    burst's 48 rows: what a sharer's reuse of another group's rows
    assumes."""
    rows = {}
    for k in (1, SP_BATCH):
        cache = model.init_cache(k, SP_PROMPT)
        tok = torch.tensor([prompt] * k, device=model.embed.device)
        with torch.no_grad():
            model(tok, cache=cache, decode="prefill", return_hidden=True)
        rows[k] = [{n: t[-1:].clone() for n, t in layer.items()
                    if n != "cache_index"} for layer in cache]
        del cache
    return all(torch.equal(a[n], b[n]) for a, b in zip(rows[1], rows[SP_BATCH])
               for n in a)


def serve_paged_phase():
    """The paged pool served end to end against the dense cache: each
    engine warmed (the extend's greedy graph too), then bursts (a) (no
    sharing), (b) (the 64-token shared head and the retried pairs) and (c)
    (300-token prompts: chunked prefill, a sharer writing from position
    160); every request's tokens compared between the two engines; the
    extend's eager and graphed ms; tok/s, TTFT, decode ms a step (the
    profiled full-batch chunk), the caches' bytes and peak memory
    printed."""
    from kubeflow_tpu_torch.ops.paged_attention import paged_gather_bytes

    res = {}
    for paged in (True, False):
        tag = "serve paged" if paged else "serve dense (paged's config)"
        t0 = time.time()
        engine = paged_engine(paged)
        cache_bytes = sum(t.numel() * t.element_size()
                          for layer in engine._cache for t in layer.values())
        pool_bytes = sum(layer[n].numel() * layer[n].element_size()
                         for layer in engine._cache
                         for n in ("cached_key", "cached_value", "key_scale",
                                   "value_scale"))
        engine.warmup(SP_LONG)
        plain, shared, long = paged_prompts(engine.model.cfg.vocab_size)
        engine.submit(plain[0], max_new_tokens=SP_CHUNK + 1)    # as the bench
        engine.run()
        log(f"{tag}: built and warmed in {time.time() - t0:.1f} s; K/V "
            f"{'pool' if paged else 'cache'} {pool_bytes / 1e9:.4f} GB "
            f"({cache_bytes / 1e9:.4f} GB with staging rows and indices)")
        sharers = note_sharers(engine) if paged else set()
        a = paged_burst(engine, f"{tag} burst (a), no shared prefix", plain)
        b = paged_burst(engine, f"{tag} burst (b), {SP_SHARED}-token shared "
                        "head", shared, sharers)
        c = paged_burst(engine, f"{tag} burst (c), {SP_LONG}-token prompts "
                        "(chunked prefill)", long, sharers, new=SP_LONG_GEN)
        if paged:
            del engine._admit_paged     # the wrapper (it holds the engine)
        extend = extend_timings(engine, tag, (0, 128, 172))
        rs = np.random.RandomState(1)
        stats = decode_breakdown(engine, rs)
        agree = None if paged else prefix_rows_agree(engine.model, shared[0])
        res[paged] = dict(a=a, b=b, c=c, cache_bytes=cache_bytes,
                          pool_bytes=pool_bytes, agree=agree, extend=extend,
                          **stats)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    pg, dn = res[True], res[False]
    if pg["b"]["shared_refs"] < 1 or pg["b"]["cow_copies"] < 1:
        raise AssertionError(f"burst (b) shared {pg['b']['shared_refs']} "
                             f"block references and forked "
                             f"{pg['b']['cow_copies']} blocks: want both > 0")
    if not pg["pool_bytes"] < dn["pool_bytes"]:
        raise AssertionError("the pool is not smaller than the dense cache")
    same_a = [x == y for x, y in zip(pg["a"]["tokens"], dn["a"]["tokens"])]
    if not all(same_a):
        raise AssertionError(f"burst (a): {same_a.count(False)} requests' "
                             "tokens differ between the paged and the dense "
                             "engine")
    same_b = [x == y for x, y in zip(pg["b"]["tokens"], dn["b"]["tokens"])]
    differ = {i for i, same in enumerate(same_b) if not same}
    log(f"serve paged: burst (a) tokens equal the dense engine's for all "
        f"{len(same_a)} requests; burst (b) for {same_b.count(True)} of "
        f"{len(same_b)} ({len(pg['b']['sharers'])} sharers; the sharers' "
        f"differing: {sorted(differ & pg['b']['sharers'])}, the holders': "
        f"{sorted(differ - pg['b']['sharers'])}); a prompt's cache rows "
        f"from prefill groups of 1 and {SP_BATCH} bitwise equal: "
        f"{dn['agree']}")
    if differ and (differ - pg["b"]["sharers"] or dn["agree"]):
        raise AssertionError("burst (b): tokens differ from the dense "
                             "engine's beyond what the prefill groups' bits "
                             "explain")
    same_c = [x == y for x, y in zip(pg["c"]["tokens"], dn["c"]["tokens"])]
    want_extends = SP_LONG_REQUESTS * 3
    if pg["c"]["extends"] != want_extends or dn["c"]["extends"] != \
            want_extends or pg["c"]["shared_refs"] < SP_LONG_HEAD // SP_BS:
        raise AssertionError(
            f"burst (c): {pg['c']['extends']} / {dn['c']['extends']} extend "
            f"dispatches (want {want_extends}), {pg['c']['shared_refs']} "
            f"shared block references (want >= {SP_LONG_HEAD // SP_BS})")
    if not all(same_c):
        raise AssertionError(f"burst (c): {same_c.count(False)} requests' "
                             "tokens differ between the paged and the dense "
                             "engine")
    log(f"serve paged: burst (c) tokens equal the dense engine's for all "
        f"{len(same_c)} requests ({pg['c']['extends']} extend dispatches "
        f"each engine, {pg['c']['shared_refs']} shared block references, "
        f"sharers {sorted(pg['c']['sharers'])})")
    gather = paged_gather_bytes(num_layers=32, batch=SP_BATCH,
                                blocks_per_seq=SP_MAX_LEN // SP_BS,
                                block_size=SP_BS, num_kv_heads=HKV,
                                head_dim=128, dtype_bytes=1)
    log(f"serve paged summary: pool {pg['pool_bytes'] / 1e9:.4f} GB against "
        f"the dense cache's {dn['pool_bytes'] / 1e9:.4f} GB; burst (a) "
        f"{pg['a']['tok_s']:.1f} tok/s (dense {dn['a']['tok_s']:.1f}), p50 "
        f"TTFT {pg['a']['ttft_p50'] * 1e3:.1f} ms "
        f"({dn['a']['ttft_p50'] * 1e3:.1f}), peak "
        f"{pg['a']['peak'] / 1e9:.2f} GB ({dn['a']['peak'] / 1e9:.2f}); "
        f"burst (b) {pg['b']['tok_s']:.1f} tok/s ({dn['b']['tok_s']:.1f}), "
        f"p50 TTFT {pg['b']['ttft_p50'] * 1e3:.1f} ms "
        f"({dn['b']['ttft_p50'] * 1e3:.1f}); decode {pg['step_ms']:.3f} "
        f"ms/step ({dn['step_ms']:.3f}), idle share "
        + ("not measured" if pg["idle"] is None else f"{pg['idle']:.3f}")
        + f"; a gather of the pool before K3 would move "
        f"{gather / 1e9:.3f} GB a step, which K3 by table does not")
    return res


def profiled(fn):
    """``fn()`` under torch.profiler, between device synchronisations:
    (wall ms, device busy ms, the device kernels' events). Busy time is
    the sum of the device-side kernel events only (the CPU ops that
    launched them carry the same time again); one stream, so their sum
    is the busy time. Late in a long run a session can lose one kernel
    event (see ``kernels_per_call``)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_ms, sum(e.device_time_total for e in kernels) / 1e3, kernels


def kernels_per_call(tag: str, kernels: int, calls: int) -> None:
    """One device kernel a call: a profiled session's kernel count of a
    kernel against the calls that launched it. The profiler loses up to
    one kernel event a session late in a long run (PR 13's runs: 4127 of
    4128 K4 kernels, 1031 of 1032 in two sessions in a row, 7 of 8 K6 in
    two more; a fresh process lost none in 11 sessions), so one short is
    taken; more kernels than calls, or two short, is a fault."""
    if not calls - 1 <= kernels <= calls:
        raise AssertionError(f"{tag} launched {kernels} kernels in the "
                             f"profiled chunk, want {calls} (one a call)")


def decode_breakdown(engine, rs, named=()):
    """One decode chunk (decode_chunk steps for every slot, all slots
    busy) under torch.profiler: wall time, device busy time (the sum of
    the device kernels' own times) and the device's idle share; then the
    wall time of three more chunks without the profiler. ``named``: kernel
    names whose (kernels, device ms) in the chunk it also returns."""
    from kubeflow_tpu_torch.models.llama import int8_launches_per_pass

    V = engine.model.cfg.vocab_size
    new = max(64, 5 * engine.cfg.decode_chunk)      # outlasts the 5 chunks
    for _ in range(engine.cfg.max_batch):
        engine.submit(rs.randint(0, V, 100).tolist(), max_new_tokens=new)
    engine.step()                       # admit + prefill + first chunk
    from kubeflow_tpu_torch.ops.norms import add_rms_norm, rms_norm

    rows_before = rms_norm.rows_launches, add_rms_norm.rows_launches
    counts_before = read_serving_counters()
    wall_ms, busy_ms, kernels = profiled(engine.step)
    rows_counts = (rms_norm.rows_launches - rows_before[0],
                   add_rms_norm.rows_launches - rows_before[1])
    chunk_counts = [a - b for a, b in zip(read_serving_counters(),
                                          counts_before)]
    steps = engine.cfg.decode_chunk
    plain = []
    for _ in range(3):                  # each step ends in a host fetch
        t0 = time.perf_counter()
        engine.step()
        plain.append((time.perf_counter() - t0) * 1e3)
    idle = 1 - busy_ms / wall_ms if busy_ms > 0 else None
    log(f"decode chunk: {steps} steps x {engine.cfg.max_batch} slots, wall "
        f"{wall_ms:.2f} ms ({wall_ms / steps:.2f} ms/step), device busy "
        + (f"{busy_ms:.2f} ms, idle share {idle:.3f}"
           if busy_ms > 0 else "not measured (no device events)")
        + "; unprofiled chunks " + " ".join(f"{x:.2f}" for x in plain)
        + f" ms ({float(np.median(plain)) / steps:.3f} ms/step median)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"  {e.key[:70]}: {e.device_time_total / 1e3:.2f} ms over "
            f"{e.count} calls")
    attn = [e for e in kernels if "decode_attn" in e.key]
    k3_launches = sum(e.count for e in attn)
    log(f"  decode_attn (K3): {sum(e.device_time_total for e in attn) / 1e3:.3f}"
        f" ms over {k3_launches} launches")
    # A call per layer per step of the chunk.
    if busy_ms > 0:
        kernels_per_call("K3", k3_launches,
                         engine.model.cfg.num_layers * steps)
    k4 = [e for e in kernels if "int8_linear" in e.key]
    k4_launches = sum(e.count for e in k4)
    k4_ms = sum(e.device_time_total for e in k4) / 1e3
    if k4 or engine.quantized:
        log(f"  int8_linear (K4): {k4_ms:.3f} ms over {k4_launches} "
            f"launches ({k4_ms / steps:.3f} ms a step)")
        if busy_ms > 0:
            kernels_per_call("K4", k4_launches,
                             int8_launches_per_pass(engine.model) * steps)
    # K6, K7, K9 and K10 by name (their launch counters, graph replays
    # counted, are asserted per burst and here per chunk; the profiler has
    # dropped one event of 2080). A decode step's rows (the slots) take
    # K6's and K10's rows kernels and K7's staged kernel: their counters
    # and their kernels by name, once a step, twice a layer a step and once
    # a layer a step.
    layers = engine.model.cfg.num_layers
    want_rows = (steps, 2 * layers * steps)
    if rows_counts != want_rows:
        raise AssertionError(f"K6, K10 rows kernel launches {rows_counts} "
                             f"in the decode chunk, want {want_rows}")
    # The chunk's counters: every step K7's staged mode once a layer (it
    # writes the staging rows); SwiGLU once a layer, as K4's epilogue where
    # the engine takes it, else as K9.
    epilogue = epilogue_engine(engine)
    check_elementwise(chunk_counts, layers, steps, steps, epilogue)
    per_launch, chunk_kernels = {}, {}
    for tag, name, per_step in (("K6", "::rmsnorm_fwd_rows", 1),
                                ("K7", "::rope_kernel", 0),
                                ("K7 staged", "::rope_stage_kernel", layers),
                                ("K9", "::swiglu_fwd",
                                 0 if epilogue else layers),
                                ("K10", "::add_rmsnorm_fwd_rows",
                                 2 * layers)):
        own = [e for e in kernels if name in e.key]
        ms, count = (sum(e.device_time_total for e in own) / 1e3,
                     sum(e.count for e in own))
        per_launch[tag] = ms / count * 1e3 if count else None
        chunk_kernels[tag] = (count, ms)
        log(f"  {tag} ({name[2:]}): {ms:.3f} ms over {count} kernels "
            f"(launched {per_step * steps})"
            + (f", {per_launch[tag]:.3f} us a launch" if count else ""))
        if busy_ms > 0 and tag in ("K6", "K7 staged", "K10"):
            kernels_per_call(f"{tag} rows", count, per_step * steps)
        if busy_ms > 0 and not per_step and count:
            raise AssertionError(f"{tag} launched {count} kernels in the "
                                 "decode chunk, want none")
    # Copy kernels: the staging writes were two a layer a step (PR 15's
    # step copied k and v into the staging rows); K7's staged mode writes
    # them now, so the chunk's copies (its flush, the graph's inputs and
    # outputs) stay below that count.
    copies = [e for e in kernels if "copy" in e.key.lower()]
    n_copies = sum(e.count for e in copies)
    copy_ms = sum(e.device_time_total for e in copies) / 1e3
    log(f"  copy kernels: {n_copies} ({copy_ms:.3f} ms; "
        f"{copy_ms / steps * 1e3:.2f} us a step) in the chunk: "
        + ", ".join(f"{e.key[:60]} x{e.count}" for e in copies[:4]))
    log(f"  device kernels a step: {sum(e.count for e in kernels) / steps:.1f}"
        f" (K3 {k3_launches / steps:.0f}, K4 {k4_launches / steps:.0f})")
    if busy_ms > 0 and n_copies >= 2 * layers * steps:
        raise AssertionError(f"{n_copies} copy kernels in the decode chunk: "
                             "the staging rows' writes would make "
                             f"{2 * layers * steps}")
    while engine.active_slots:
        engine.step()
    stats = {}
    for name in named:
        own = [e for e in kernels if name in e.key]
        stats[name] = (sum(e.count for e in own),
                       sum(e.device_time_total for e in own) / 1e3)
    return dict(**({"named": stats} if named else {}),
                chunk_wall_ms=wall_ms, chunk_busy_ms=busy_ms, idle=idle,
                step_ms=float(np.median(plain)) / steps,
                k3_chunk_launches=k3_launches,
                k4_chunk_launches=k4_launches, k4_chunk_ms=k4_ms,
                k10_chunk_us=per_launch["K10"],
                k7s_chunk_us=per_launch["K7 staged"],
                k9_chunk_us=per_launch["K9"],
                launches_a_step=sum(e.count for e in kernels) / steps,
                copies_a_step=n_copies / steps,
                copy_us_a_step=copy_ms / steps * 1e3)


def greedy_check(model, bodies, outs, kv_int8: bool = False):
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
    on. With ``kv_int8`` the re-forwards read k/v as the int8 cache holds
    them where the engine read the cache (the decode steps, query rows >=
    L): quantized and dequantized per row (quantize_kv_rows); the
    prefill's own rows (< L) read the live k/v, as the engine's prefill
    does. Returns the gaps and the bounds."""
    from kubeflow_tpu_torch.models.llama import (
        Attention,
        Llama,
        quantize_kv_rows,
    )

    plain_attend = Attention.attend
    prompt_len = [0]

    def attend_int8(q, k, v, attn_impl="flash"):
        def dequant(x):
            x8, s = quantize_kv_rows(x)
            return (x8.float() * s).to(x.dtype)

        live = plain_attend(q, k, v, attn_impl)
        cached = plain_attend(q, dequant(k), dequant(v), attn_impl)
        decode_rows = torch.arange(q.shape[1], device=q.device) \
            >= prompt_len[0]
        return torch.where(decode_rows[None, :, None, None], cached, live)

    if kv_int8:
        Attention.attend = staticmethod(attend_int8)
    try:
        return _greedy_check(model, bodies, outs, prompt_len)
    finally:
        Attention.attend = staticmethod(plain_attend)


def _greedy_check(model, bodies, outs, prompt_len):
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
            L = prompt_len[0] = len(prompt)
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


def fused_counters():
    """The launch counters of a train step's kernels, K1 and K2 (K1's
    backward), K5-K10 and K11: (name, object, attribute)."""
    from kubeflow_tpu_torch.ops import adafactor
    from kubeflow_tpu_torch.ops import optimizer as fused
    from kubeflow_tpu_torch.ops.cross_entropy import cross_entropy_sums
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.ops.norms import add_rms_norm, rms_norm
    from kubeflow_tpu_torch.ops.rope import apply_rope
    from kubeflow_tpu_torch.ops.swiglu import swiglu

    return (("K1 forward", flash_attention, "fwd_launches"),
            ("K1 backward", flash_attention, "bwd_launches"),
            ("K5 norm", fused.global_norm, "launches"),
            ("K5 update", fused.update, "launches"),
            ("K11 update", adafactor.update, "launches"),
            ("K6 forward", rms_norm, "fwd_launches"),
            ("K6 backward", rms_norm, "bwd_launches"),
            ("K7 forward", apply_rope, "fwd_launches"),
            ("K7 backward", apply_rope, "bwd_launches"),
            ("K8 forward", cross_entropy_sums, "fwd_launches"),
            ("K8 backward", cross_entropy_sums, "bwd_launches"),
            ("K9 forward", swiglu, "fwd_launches"),
            ("K9 backward", swiglu, "bwd_launches"),
            ("K10 forward", add_rms_norm, "fwd_launches"),
            ("K10 backward", add_rms_norm, "bwd_launches"),
            ("K6 rows", rms_norm, "rows_launches"),
            ("K10 rows", add_rms_norm, "rows_launches"))


def train_launches_per_step(layers: int, policy: str = "qkv_attn",
                            optimizer: str = "adamw") -> dict:
    """Each kernel's launches a train step of a ``layers``-layer model
    under remat ``policy``. The forward: a layer's input norm (K6), RoPE
    of q and k in one launch (K7), attention (K1), the add + post-attention
    norm (K10) and SwiGLU (K9), and the final norm (K6); the layer's
    closing add stays eager under remat (a checkpoint boundary lies
    between it and the next norm). The backward replays each checkpointed
    segment up to the last tensor it saves: every policy replays the input
    norm, K10 and K9 (nothing saves their outputs); RoPE replays except
    under "minimal" (it saves q and k after RoPE outside any segment), K1
    except under "minimal" and "qkv_attn_lse" (they keep K1's o and lse).
    One backward each; one norm and one update of the optimizer: K5's, or
    K11 alone for adafactor (it computes the norm itself). The step's rows
    (batch x sequence) are past ops/norms.py's ROWS_MAX: no rows kernel."""
    rope_replays = policy != "minimal"
    attn_replays = policy not in ("minimal", "qkv_attn_lse")
    adafactor = optimizer == "adafactor"
    return {"K1 forward": layers * (1 + attn_replays),
            "K1 backward": layers, "K5 norm": int(not adafactor),
            "K5 update": int(not adafactor), "K11 update": int(adafactor),
            "K6 rows": 0, "K10 rows": 0,
            "K6 forward": 2 * layers + 1, "K6 backward": layers + 1,
            "K7 forward": layers * (1 + rope_replays), "K7 backward": layers,
            "K8 forward": 1, "K8 backward": 1,
            "K9 forward": 2 * layers, "K9 backward": layers,
            "K10 forward": 2 * layers, "K10 backward": layers}


def train_phase():
    """The runner on the 700M config: 10 steps with checkpoints, then a
    resume to 12. Returns the first run's stats. Its checkpoints (5.6 GB
    each) go to a temporary directory that is removed however it ends."""
    import tempfile

    work = tempfile.mkdtemp(prefix="kftpu-smoke-train-")
    try:
        return _train_runs(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _train_runs(work: str):
    from kubeflow_tpu_torch.models.llama import LlamaConfig
    from kubeflow_tpu_torch.ops import optimizer as fused
    from kubeflow_tpu_torch.train import runner
    from kubeflow_tpu_torch.train.checkpoint import CheckpointService
    from kubeflow_tpu_torch.train.flops import train_flops_per_token
    from kubeflow_tpu_torch.train.trainer import Trainer

    ckdir = os.path.join(work, "ckpt")
    os.environ.update({
        "KFTPU_MODEL": "llama-tiny", "KFTPU_MODEL_KW": json.dumps(
            TRAIN_MODEL_KW),
        "KFTPU_HPARAMS": json.dumps({"warmup_steps": 2,
                                     "mu_dtype": "bfloat16"}),
        "KFTPU_BATCH_PER_HOST": str(TRAIN_BATCH),
        "KFTPU_SEQ_LEN": str(TRAIN_SEQ), "KFTPU_ATTN_IMPL": "flash",
        "KFTPU_CHECKPOINT_DIR": ckdir, "KFTPU_CHECKPOINT_EVERY": "5",
        "KFTPU_TERMINATION_LOG": os.path.join(work, "termination.json"),
    })
    os.environ.pop("KFTPU_PLATFORM", None)          # cuda
    layers = TRAIN_MODEL_KW["num_layers"]

    # Each step is timed between synchronisations and its loss read; the
    # last (trainer, state, batch) is kept for the profiled step.
    record = {"losses": [], "step_ms": [], "last": None}
    plain_step = Trainer.step

    def timed_step(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = plain_step(self, state, batch)
        loss = float(metrics["loss"])
        record["step_ms"].append((time.perf_counter() - t0) * 1e3)
        record["losses"].append(loss)
        record["last"] = (self, state, batch)
        return state, metrics

    Trainer.step = timed_step
    runs = []
    try:
        for steps, resumed_from in ((10, 0), (12, 10)):
            os.environ["KFTPU_TRAIN_STEPS"] = str(steps)
            record["losses"], record["step_ms"] = [], []
            torch.cuda.reset_peak_memory_stats()
            for _, obj, attr in fused_counters():
                setattr(obj, attr, 0)
            builds0 = fused.update.table_builds
            t0 = time.time()
            runner.run(runner.env_config())
            wall = time.time() - t0
            fused_n = {name: getattr(obj, attr)
                       for name, obj, attr in fused_counters()}
            fwd, bwd = fused_n["K1 forward"], fused_n["K1 backward"]
            builds = fused.update.table_builds - builds0
            peak = torch.cuda.max_memory_allocated()
            ran = steps - resumed_from
            losses = record["losses"]
            with open(os.environ["KFTPU_TERMINATION_LOG"]) as f:
                report = json.load(f)
            if len(losses) != ran or record["last"][1].step != steps:
                raise AssertionError(f"train to {steps}: ran {len(losses)} "
                                     f"steps, expected {ran} from "
                                     f"{resumed_from}")
            if not all(np.isfinite(losses)):
                raise AssertionError(f"non-finite loss: {losses}")
            # K2 once per layer per step; K1 twice: the forward and, under
            # remat "qkv_attn", its replay in the backward (lse is not
            # saved), as the JAX policy replays it; K5-K10: every launch
            # the table of launches a step predicts.
            want = {k: v * ran for k, v in train_launches_per_step(
                layers, TRAIN_MODEL_KW["remat_policy"]).items()}
            if fused_n != want:
                raise AssertionError(f"launches over {ran} steps: "
                                     f"{fused_n}, want {want}")
            # K5's tables, built at most once for the run's parameter set:
            # the update's, and the norm's (which holds sizes and dtypes
            # alone, so an earlier set of the same shapes may have built it).
            if builds > 2:
                raise AssertionError(f"K5's tables built {builds} times "
                                     f"over {ran} steps, want at most 2")
            runs.append(dict(steps=steps, losses=list(losses),
                             step_ms=list(record["step_ms"]), wall=wall,
                             fwd=fwd, bwd=bwd, fused=fused_n, peak=peak,
                             report=report))
            log(f"train to step {steps} (from {resumed_from}): losses "
                + " ".join(f"{x:.4f}" for x in losses)
                + f"; K1 {fwd} K2 {bwd} launches; "
                + ", ".join(f"{k} {v}" for k, v in fused_n.items()
                            if not k.startswith("K1 "))
                + f" (K5's pointer tables built {builds} times)"
                + "; runner tokens/s "
                f"{report['tokens_per_sec']:.0f}; wall {wall:.1f} s; peak "
                f"device memory {peak / 1e9:.2f} GB")
        first = runs[0]
        if not first["losses"][-1] < first["losses"][0]:
            raise AssertionError(f"loss did not fall: {first['losses']}")
        saved = CheckpointService(ckdir).all_steps()
        if saved != [5, 10, 12]:
            raise AssertionError(f"checkpoints {saved}, want [5, 10, 12]")
        trainer, state, batch = record["last"]
    finally:
        Trainer.step = plain_step
        record.clear()
    cfg = LlamaConfig(**TRAIN_MODEL_KW)
    step_ms = float(np.median(first["step_ms"][1:]))   # first: warm-up
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (step_ms / 1e3)
    mfu = train_flops_per_token(cfg, TRAIN_SEQ) * tok_s / PEAK_BF16_FLOPS
    log(f"train: {tokens} tokens/step, median synchronised step "
        f"{step_ms:.1f} ms (steps 2-10: " + " ".join(
            f"{x:.1f}" for x in first["step_ms"][1:]) + f"), {tok_s:.0f} "
        f"tokens/s, MFU {mfu:.4f} ({train_flops_per_token(cfg, TRAIN_SEQ)}"
        f" FLOP/token), peak device memory {first['peak'] / 1e9:.2f} GB; "
        f"resumed from step 10 to 12; checkpoints {saved}")
    breakdown = train_breakdown(trainer, state, batch)
    return dict(first, step_ms_median=step_ms, tok_s=tok_s, mfu=mfu,
                breakdown=breakdown)


#: The port's kernels in a train step, by the names of their device kernels.
TRAIN_KERNELS = {
    "K1": ("flash_fwd",), "K2": ("flash_bwd",),
    "K5": ("::norm_partial", "::norm_final", "::update<"),
    "K6": ("::rmsnorm_fwd", "::rmsnorm_bwd", "::rmsnorm_dw"),
    "K7": ("::rope_kernel",), "K8": ("::ce_fwd", "::ce_sum", "::ce_bwd"),
    "K9": ("::swiglu_fwd", "::swiglu_bwd"),
    "K10": ("::add_rmsnorm_fwd", "::add_rmsnorm_bwd", "::add_rmsnorm_dw"),
    "K11": K11_PASSES}
#: The profiler ranges ``Trainer.step`` opens (record_function).
TRAIN_RANGES = ("forward", "loss", "backward", "grad_norm", "optimizer")
NODE_PREFIX = "autograd::engine::evaluate_function: "


def _is_kernel(e) -> bool:
    """A device kernel event, not a record_function range's device span."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def attribute(events, ranges=TRAIN_RANGES):
    """Device ms of a profiled step by range, by autograd node and by op.

    Each device kernel is linked by the profiler to the innermost CPU
    event that launched it (``FunctionEvent.kernels``). That event is
    assigned to the range whose CPU interval holds its start, on any
    thread (the backward's nodes run on autograd's device thread while
    the "backward" range is open on the main one), and to the innermost
    ``evaluate_function`` node on its own thread that holds its start.
    The CUDA runtime's "Command Buffer Full" stalls are linked to the
    kernels they delayed, which their launching ops also own, so they are
    skipped. Returns (by range, by node, by op within each range), in ms."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and not e.name.startswith("Command Buffer Full")]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in ranges]
    nodes = {}
    for e in cpu:
        if e.name.startswith(NODE_PREFIX):
            nodes.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end,
                 e.name[len(NODE_PREFIX):]))
    by_range, by_node, by_op = {}, {}, {}
    for e in cpu:
        ms = sum(k.duration for k in e.kernels) / 1e3
        if ms <= 0:
            continue
        t = e.time_range.start
        rng = next((n for a, b, n in spans if a <= t <= b), "other")
        by_range[rng] = by_range.get(rng, 0.0) + ms
        inner = [(a, n) for a, b, n in nodes.get(e.thread, ())
                 if a <= t <= b]
        if e.name.startswith(NODE_PREFIX):
            node = e.name[len(NODE_PREFIX):]
        elif inner:
            node = max(inner)[1]
        else:
            node = None
        if node is not None:
            by_node[node] = by_node.get(node, 0.0) + ms
        ops = by_op.setdefault(rng, {})
        ops[e.name] = ops.get(e.name, 0.0) + ms
    return by_range, by_node, by_op


def range_spans(events, ranges=TRAIN_RANGES) -> dict:
    """Device ms of the kernels inside each range's device-side span (the
    profiler's device annotation of a record_function range), by kernel
    start: it also counts kernels no CPU op claims, as K5's, which ctypes
    launches under the grad_norm and optimizer ranges. Empty when the
    profiler records no device spans."""
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in dev
             if getattr(e, "is_user_annotation", False) and e.name in ranges]
    out = {}
    for e in dev:
        if getattr(e, "is_user_annotation", False):
            continue
        t = e.time_range.start
        rng = next((n for a, b, n in spans if a <= t <= b), None)
        if rng is not None:
            out[rng] = out.get(rng, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def train_breakdown(trainer, state, batch):
    """One train step under torch.profiler: wall time, device busy time
    (the sum of the device kernels' own times), idle share, top kernels,
    and the device ms attributed by range, autograd node and op
    (``attribute``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    log(f"train step profiled: wall {wall_ms:.2f} ms, device busy "
        + (f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}"
           if busy_ms > 0 else "not measured (no device events)"))
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        log(f"  {e.key[:70]}: {e.device_time_total / 1e3:.2f} ms over "
            f"{e.count} calls")
    by_kernel = {}
    for tag, names in TRAIN_KERNELS.items():      # the port's kernels' share
        own = [e for e in kernels if any(n in e.key for n in names)]
        by_kernel[tag] = (sum(e.device_time_total for e in own) / 1e3,
                          sum(e.count for e in own))
        log(f"  {tag} ({'/'.join(names)}*): {by_kernel[tag][0]:.2f} ms over "
            f"{by_kernel[tag][1]} kernels")
    by_range, by_node, by_op = attribute(prof.events())
    by_span = range_spans(prof.events())
    log("  device ms by range: " + ", ".join(
        f"{k} {by_range.get(k, 0.0):.2f}" for k in TRAIN_RANGES + ("other",))
        + f" (sum {sum(by_range.values()):.2f} of busy {busy_ms:.2f}; "
        f"the rest launched by no CPU op)")
    log("  device ms by range's device span: " + (", ".join(
        f"{k} {by_span.get(k, 0.0):.2f}" for k in TRAIN_RANGES)
        if by_span else "not measured (no device spans)"))
    log("  device ms by backward node: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(by_node.items(),
                                          key=lambda kv: -kv[1])[:16]))
    for rng in TRAIN_RANGES:
        ops = by_op.get(rng, {})
        log(f"  {rng} by op: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(ops.items(),
                                              key=lambda kv: -kv[1])[:12]))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_range=by_range,
                by_span=by_span, by_node=by_node, by_kernel=by_kernel)


# The train fused/policies phase: the train phase's model with both fused
# projections, under every remat policy ("full" first: the others are held
# to its step 1), a warm-up step and three timed ones each.
FUSED_FLAGS = {"fused_qkv": True, "fused_gate_up": True}
POLICIES = ("full", "qkv_attn", "qkv_attn_lse", "minimal", "attn_only",
            "mlp_only", "dots")
POLICY_STEPS = 4


def train_policies_phase():
    """The ~700M model with fused_qkv and fused_gate_up under each of the
    seven remat policies, each run through the runner (KFTPU_MODEL_KW
    names the flags and the policy) from seed 0, so every policy starts
    from the same weights and takes the same batches. Per policy: step
    1's loss and gradient norm against "full"'s (bitwise: the kernels are
    deterministic and a replay launches what the forward launched), every
    step's launches of K1, K2 and K5-K10 against train_launches_per_step,
    the median of steps 2-4 (synchronised), MFU and the peak device
    memory. Returns {policy: row}."""
    import tempfile

    from kubeflow_tpu_torch.models.llama import LlamaConfig
    from kubeflow_tpu_torch.train import runner
    from kubeflow_tpu_torch.train.flops import train_flops_per_token
    from kubeflow_tpu_torch.train.trainer import Trainer

    layers = TRAIN_MODEL_KW["num_layers"]
    work = tempfile.mkdtemp(prefix="kftpu-smoke-policies-")
    plain_step = Trainer.step
    record = []

    def timed_step(self, state, batch):
        for _, obj, attr in fused_counters():
            setattr(obj, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = plain_step(self, state, batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        record.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                           grad_norm=norm, launches={
                               name: getattr(obj, attr)
                               for name, obj, attr in fused_counters()}))
        return state, metrics

    os.environ.update({
        "KFTPU_MODEL": "llama-tiny",
        "KFTPU_HPARAMS": json.dumps({"warmup_steps": 2,
                                     "mu_dtype": "bfloat16"}),
        "KFTPU_BATCH_PER_HOST": str(TRAIN_BATCH),
        "KFTPU_SEQ_LEN": str(TRAIN_SEQ), "KFTPU_ATTN_IMPL": "flash",
        "KFTPU_CHECKPOINT_DIR": "", "KFTPU_TRAIN_STEPS": str(POLICY_STEPS),
        "KFTPU_TERMINATION_LOG": os.path.join(work, "termination.json"),
    })
    os.environ.pop("KFTPU_PLATFORM", None)          # cuda
    cfg = LlamaConfig(**TRAIN_MODEL_KW, **FUSED_FLAGS)
    flops = train_flops_per_token(cfg, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rows = {}
    Trainer.step = timed_step
    try:
        for policy in POLICIES:
            os.environ["KFTPU_MODEL_KW"] = json.dumps(dict(
                TRAIN_MODEL_KW, **FUSED_FLAGS, remat_policy=policy))
            record.clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runner.run(runner.env_config())
            peak = torch.cuda.max_memory_allocated()
            if len(record) != POLICY_STEPS:
                raise AssertionError(f"{policy}: ran {len(record)} steps")
            want = train_launches_per_step(layers, policy)
            for i, r in enumerate(record):
                if r["launches"] != want:
                    raise AssertionError(f"{policy} step {i + 1} launches "
                                         f"{r['launches']}, want {want}")
            step_ms = float(np.median([r["ms"] for r in record[1:]]))
            first = record[0]
            if not (np.isfinite(first["loss"])
                    and np.isfinite(first["grad_norm"])):
                raise AssertionError(f"{policy}: step 1 {first}")
            base = rows.get("full", dict(loss=first["loss"],
                                         grad_norm=first["grad_norm"]))
            if (first["loss"], first["grad_norm"]) != (base["loss"],
                                                       base["grad_norm"]):
                raise AssertionError(
                    f"{policy}: step 1 loss {first['loss']!r}, grad norm "
                    f"{first['grad_norm']!r}; full's {base['loss']!r}, "
                    f"{base['grad_norm']!r}")
            mfu = flops * tokens / (step_ms / 1e3) / PEAK_BF16_FLOPS
            rows[policy] = dict(loss=first["loss"],
                                grad_norm=first["grad_norm"],
                                step_ms=step_ms, mfu=mfu, peak=peak,
                                steps_ms=[r["ms"] for r in record],
                                launches=want)
            log(f"train fused [{policy}]: step 1 loss {first['loss']!r}, "
                f"grad norm {first['grad_norm']!r} (full's, bitwise); steps "
                + " ".join(f"{r['ms']:.1f}" for r in record)
                + f" ms, median of 2-{POLICY_STEPS} {step_ms:.1f} ms, MFU "
                f"{mfu:.4f}, peak device memory {peak / 1e9:.2f} GB; "
                f"launches a step: K1 {want['K1 forward']} + K2 "
                f"{want['K1 backward']}, K6 {want['K6 forward']} + "
                f"{want['K6 backward']}, K7 {want['K7 forward']} + "
                f"{want['K7 backward']}, K9 {want['K9 forward']} + "
                f"{want['K9 backward']}, K10 {want['K10 forward']} + "
                f"{want['K10 backward']} (asserted each step)")
    finally:
        Trainer.step = plain_step
        shutil.rmtree(work, ignore_errors=True)
    return rows


def fused_state_dict(sd: dict, cfg) -> dict:
    """``sd`` of the unfused model with each layer's q/k/v rows
    interleaved into qkv_proj (kv head, slot, d) and its gate/up rows
    concatenated into gate_up_proj; every other entry is ``sd``'s own
    tensor."""
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = dict(sd)
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        q, k, v = (out.pop(f"{pre}attn.{n}_proj.weight") for n in "qkv")
        E = q.shape[1]
        out[f"{pre}attn.qkv_proj.weight"] = torch.cat(
            [q.view(Hkv, H // Hkv, D, E), k.view(Hkv, 1, D, E),
             v.view(Hkv, 1, D, E)], dim=1).reshape(-1, E)
        out[f"{pre}mlp.gate_up_proj.weight"] = torch.cat(
            [out.pop(f"{pre}mlp.gate_proj.weight"),
             out.pop(f"{pre}mlp.up_proj.weight")])
    return out


def engine_burst(engine, prompts, new: int, tag: str):
    """All ``prompts`` submitted at once (greedy, ``new`` tokens each) and
    run to the drain; the launch counts of K1, K3, K4, K6, K7, K9 and K10
    zeroed just before and checked just after (graph replays counted).
    Returns (tokens, tok/s, p50 TTFT)."""
    from kubeflow_tpu_torch.models.llama import int8_launches_per_pass
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    flash_attention.fwd_launches = decode_attention.launches = 0
    int8_linear.launches = 0
    zero_serving_counters()
    engine.prefill_dispatches = engine.extend_dispatches = 0
    engine.decode_dispatches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [engine.result(r) for r in rids]
    layers = engine.model.cfg.num_layers
    chunk = engine.cfg.decode_chunk
    prefills, extends = engine.prefill_dispatches, engine.extend_dispatches
    decodes = engine.decode_dispatches
    passes = chunk * decodes + prefills + extends
    k1, k3, k4 = (flash_attention.fwd_launches, decode_attention.launches,
                  int8_linear.launches)
    if any(r is None or len(r.tokens) != new for r in res):
        raise AssertionError(f"{tag}: a request lacks its {new} tokens")
    if k1 != layers * (prefills + extends) or \
            k3 != layers * chunk * decodes or \
            k4 != int8_launches_per_pass(engine.model) * passes:
        raise AssertionError(f"{tag}: K1 {k1}, K3 {k3}, K4 {k4} launches "
                             f"for {prefills} prefill, {extends} extend and "
                             f"{decodes} decode dispatches")
    counts = read_serving_counters()
    check_elementwise(counts, layers, passes, chunk * decodes,
                      epilogue_engine(engine))
    generated = new * len(res)
    ttft = float(np.median([r.ttft_s for r in res]))
    log(f"{tag} burst: {len(res)} requests, {generated} tokens in "
        f"{wall:.2f} s = {generated / wall:.1f} tok/s, p50 TTFT "
        f"{ttft * 1e3:.1f} ms; {prefills} prefill + {extends} extend + "
        f"{decodes} decode dispatches; launches K1 {k1}, K3 {k3}, K4 {k4} "
        f"({int8_launches_per_pass(engine.model)} a pass), "
        + "/".join(SERVING_COUNTERS) + " " + "/".join(map(str, counts)))
    return [r.tokens for r in res], generated / wall, ttft


def serve_fused_phase():
    """llama3-8b with fused_qkv and fused_gate_up and int8 weights (8
    slots, max_len 1024, chunk 8, staged decode, CUDA graphs), driven
    through the engine, against the unfused int8-weight engine built on
    the same random weights (seed 0; the fused rows are the unfused ones
    interleaved, so each quantizes to the same int8 rows and scales): a
    greedy 9-request burst of 32 new tokens (prompts 20-700 tokens, one
    past the largest bucket) through each, tokens compared, launches
    checked; then each engine's profiled decode chunk and decode ms a
    step. Where a request's tokens differ, both sides' tokens must be the
    f32 re-forward's argmax within the bf16 noise (``greedy_check``: a
    near-tie may break either way); it reports how many differ."""
    from kubeflow_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        dequantized_state_dict,
    )
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    def config(fused):
        return LlamaConfig.llama3_8b(
            param_dtype="bfloat16", decode_staging=8,
            **(FUSED_FLAGS if fused else {}))

    def engine(model):
        return ServingEngine(model, ServingConfig(
            max_batch=8, max_len=1024, decode_chunk=8, quantize="int8",
            param_dtype="bfloat16"), device="cuda",
            registry=MetricsRegistry())

    t0 = time.time()
    with torch.device("cuda"):
        plain = Llama(config(False))
    plain.init_weights(torch.Generator(device="cuda").manual_seed(0))
    with torch.device("meta"):
        fused = Llama(config(True))
    fused.load_state_dict(fused_state_dict(plain.state_dict(), plain.cfg),
                          assign=True)
    engines = {"unfused": engine(plain), "fused": engine(fused)}
    del plain, fused
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve fused int8 weights: two llama3-8b int8-weight engines "
        f"(unfused, fused) built in {time.time() - t0:.1f} s; "
        f"{len(engines['fused'].quantized)} int8 projections fused, "
        f"{len(engines['unfused'].quantized)} unfused")
    rs = np.random.RandomState(0)
    V = 128256
    lengths = (20, 30, 100, 120, 200, 250, 400, 500, 700)
    prompts = [rs.randint(0, V, n).tolist() for n in lengths]
    out = {}
    for name, eng in engines.items():
        t0 = time.time()
        eng.warmup(700)
        tag = f"serve fused int8 weights [{name}]"
        log(f"{tag}: warmup {time.time() - t0:.1f} s")
        toks, tok_s, ttft = engine_burst(eng, prompts, 32, tag)
        out[name] = dict(tokens=toks, tok_s=tok_s, ttft_p50=ttft,
                         **decode_breakdown(eng, rs))
    differ = [i for i, (a, b) in enumerate(zip(out["fused"]["tokens"],
                                               out["unfused"]["tokens"]))
              if a != b]
    if differ:
        model = engines["fused"].model
        with torch.device("meta"):
            check = Llama(model.cfg)
        check.load_state_dict(dequantized_state_dict(model), assign=True)
        for name in ("fused", "unfused"):
            greedy_check(check, [{"tokens": prompts[i]} for i in differ],
                         [{"tokens": out[name]["tokens"][i]}
                          for i in differ])
        del check
    log(f"serve fused int8 weights: greedy tokens {len(prompts) - len(differ)}"
        f" of {len(prompts)} requests equal to the unfused engine's"
        + (f" (requests {differ} differ, each side the f32 argmax within "
           "the bf16 noise)" if differ else "")
        + f"; decode {out['fused']['step_ms']:.3f} ms a step fused, "
        f"{out['unfused']['step_ms']:.3f} unfused; burst "
        f"{out['fused']['tok_s']:.1f} / {out['unfused']['tok_s']:.1f} tok/s")
    for name in list(engines):
        out[name].pop("tokens")
        del engines[name]
    out["differ"] = len(differ)
    return out


# The serve mixtral phase: mixtral-8x7b at its published width, cut to 16
# of its 32 layers so that its bf16 weights (46.97 GB) fit one card.
MIXTRAL_LAYERS = 16
MOE_COUNTERS = ("K12", "K13", "K14")


def moe_counters():
    from kubeflow_tpu_torch.ops import moe

    return ((moe.route, "launches"), (moe.gather_rows, "launches"),
            (moe.combine_rows, "launches"))


class plain_moe:
    """Within the block, the MoE layer's dispatch runs K12-K14's plain
    versions (ops/moe.py) in place of the kernels: the check's swap,
    never the served path's."""

    def __enter__(self):
        from kubeflow_tpu_torch.ops import moe
        from kubeflow_tpu_torch.parallel import moe as dispatch

        self.saved = (dispatch.route, dispatch.gather_rows,
                      dispatch.combine_rows)
        dispatch.route, dispatch.gather_rows, dispatch.combine_rows = (
            moe.route_reference, moe.gather_rows_reference,
            moe.combine_rows_reference)
        return self

    def __exit__(self, *exc):
        from kubeflow_tpu_torch.parallel import moe as dispatch

        dispatch.route, dispatch.gather_rows, dispatch.combine_rows = \
            self.saved


def replay_step(model, snap, plain: bool):
    """One decode step of the served burst replayed eagerly from ``snap``
    (the dispatch's tokens, positions and a copy of every cache tensor,
    staging rows included; a staged step at column 0, as the chunk's
    first step runs): (greedy tokens [B], [(MoE input, MoE output)] a
    layer)."""
    cache = [{k: v.clone() for k, v in layer.items()}
             for layer in snap["cache"]]
    records = []
    hooks = [layer.mlp.register_forward_hook(
        lambda m, i, o: records.append((i[0].clone(), o.clone())))
        for layer in model.layers]
    try:
        with torch.no_grad():
            if plain:
                with plain_moe():
                    logits, _ = model(snap["tokens"],
                                      positions=snap["positions"],
                                      cache=cache, decode=True, stage_step=0)
            else:
                logits, _ = model(snap["tokens"], positions=snap["positions"],
                                  cache=cache, decode=True, stage_step=0)
    finally:
        for h in hooks:
            h.remove()
    return torch.argmax(logits[:, 0].float(), dim=-1), records


def serve_mixtral_phase():
    """mixtral-8x7b at full published width cut to MIXTRAL_LAYERS layers
    (4096 wide, 32/8 heads of 128, 8 experts of 14336, vocab 32000,
    rope_theta 1e6), random bf16 weights made on the card from seed 0,
    served through the engine as the JAX server builds it (8 slots,
    max_len 1024, chunk 8, staged decode, CUDA graphs, bf16 KV cache),
    warmed with a 700-token length: a greedy burst of 9 requests (20-700
    tokens, the 700-token one through the chunked extend) of 32 new
    tokens. Checks the token counts; K1, K3, K6, K7, K9 and K10 as the
    Llama bursts (``engine_burst``) and K12, K13 and K14 once a layer a
    forward pass (decode step, prefill group, extend chunk; graph replays
    counted). Then one decode dispatch of the burst (its first step,
    whose inputs, cache and staging rows were copied before it was
    queued) is replayed eagerly with the kernels and with K12-K14 swapped
    for their plain versions: each layer's MoE output, on the kernels'
    layer input, bitwise the kernels', and the replay's greedy tokens
    equal to the served ones. Prints decode ms a step beside its byte
    bound (every weight but the embedding read once: 13.94 ms at 3.35
    TB/s), tok/s, peak memory, weight bytes and the phase's seconds; a
    profiled decode chunk with K12-K14's kernels by name."""
    from kubeflow_tpu_torch.models.mixtral import Mixtral, MixtralConfig
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    t_phase = time.time()
    cfg = MixtralConfig.mixtral_8x7b(num_layers=MIXTRAL_LAYERS,
                                     param_dtype="bfloat16",
                                     decode_staging=8)
    with torch.device("cuda"):
        model = Mixtral(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    step_bytes = weight_bytes - model.embed.numel() * model.embed.element_size()
    engine = ServingEngine(model, ServingConfig(
        max_batch=8, max_len=1024, decode_chunk=8, param_dtype="bfloat16"),
        device="cuda", registry=MetricsRegistry())
    t0 = time.time()
    engine.warmup(700)
    log(f"serve mixtral: mixtral-8x7b, {MIXTRAL_LAYERS} layers, weights "
        f"{weight_bytes / 1e9:.2f} GB; warmup {time.time() - t0:.1f} s")

    snap = {}
    served = engine._run_decode

    def spy(tokens, positions, samp):
        # The third decode dispatch of the burst: every slot is busy.
        snap["calls"] = snap.get("calls", 0) + 1
        if snap["calls"] != 3:
            return served(tokens, positions, samp)
        snap.update(tokens=tokens.clone(),
                    positions=torch.as_tensor(positions, device="cuda"),
                    cache=[{k: v.clone() for k, v in layer.items()}
                           for layer in engine._cache])
        out = served(tokens, positions, samp)
        snap["served"] = out[0][:, 0].clone()
        return out

    rs = np.random.RandomState(0)
    lengths = (20, 30, 100, 120, 200, 250, 400, 500, 700)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    for fn, name in moe_counters():
        setattr(fn, name, 0)
    engine._run_decode = spy
    torch.cuda.reset_peak_memory_stats()
    try:
        _, tok_s, ttft = engine_burst(engine, prompts, 32, "serve mixtral")
    finally:
        del engine._run_decode
    peak = torch.cuda.max_memory_allocated()
    passes = (engine.cfg.decode_chunk * engine.decode_dispatches
              + engine.prefill_dispatches + engine.extend_dispatches)
    moe_launches = [getattr(fn, name) for fn, name in moe_counters()]
    if moe_launches != [MIXTRAL_LAYERS * passes] * 3:
        raise AssertionError(f"serve mixtral: K12/K13/K14 launches "
                             f"{moe_launches}, want {MIXTRAL_LAYERS} a "
                             f"layer for each of {passes} forward passes")
    if "served" not in snap:
        raise AssertionError("serve mixtral: the burst made fewer than 3 "
                             "decode dispatches")

    # The replay: the kernels eagerly, then K12-K14's plain versions on
    # each layer's input (bitwise) and through the whole step (tokens).
    kernel_tokens, kernel_moe = replay_step(model, snap, plain=False)
    with plain_moe(), torch.no_grad():
        for i, (layer, (x, y)) in enumerate(zip(model.layers, kernel_moe)):
            _bitwise(f"serve mixtral: layer {i}'s MoE output",
                     [(y, layer.mlp(x))])
    plain_tokens, _ = replay_step(model, snap, plain=True)
    if not torch.equal(plain_tokens, snap["served"]):
        raise AssertionError(
            f"serve mixtral: the plain versions' replay gives "
            f"{plain_tokens.tolist()}, the served step "
            f"{snap['served'].tolist()}")
    log(f"serve mixtral: decode dispatch 3 replayed eagerly: each of "
        f"{MIXTRAL_LAYERS} layers' MoE output bitwise with K12-K14's plain "
        f"versions on its input; greedy tokens {plain_tokens.tolist()} equal "
        f"the served ones (the kernels' eager replay's "
        + ("equal too)" if torch.equal(kernel_tokens, snap["served"])
           else f"differ: {kernel_tokens.tolist()})"))
    del snap, kernel_moe

    names = ("moe_route", "moe_gather", "moe_combine")
    bd = decode_breakdown(engine, rs, names)
    kernels_ms = {tag: bd["named"][name]
                  for tag, name in zip(MOE_COUNTERS, names)}
    steps = engine.cfg.decode_chunk
    if bd["chunk_busy_ms"] > 0:
        for tag, (n, _) in kernels_ms.items():
            kernels_per_call(tag, n, MIXTRAL_LAYERS * steps)
    bound = bytes_ms(step_bytes)
    seconds = time.time() - t_phase
    log(f"serve mixtral summary: decode {bd['step_ms']:.3f} ms a step "
        f"against its byte bound {bound:.2f} ms ({step_bytes / 1e9:.2f} GB "
        f"of weights at 3.35 TB/s); burst {tok_s:.1f} tok/s, p50 TTFT "
        f"{ttft * 1e3:.1f} ms; peak {peak / 1e9:.2f} GB; weights "
        f"{weight_bytes / 1e9:.2f} GB; idle share "
        + ("not measured" if bd["idle"] is None else f"{bd['idle']:.3f}")
        + "; in one profiled chunk " + ", ".join(
            f"{tag} {n} kernels {ms:.3f} ms" for tag, (n, ms)
            in kernels_ms.items())
        + f"; phase {seconds:.1f} s")
    del engine, model
    return dict(step_ms=bd["step_ms"], bound_ms=bound, tok_s=tok_s,
                ttft_p50=ttft, peak=peak, weight_bytes=weight_bytes,
                idle=bd["idle"], launches=moe_launches,
                chunk_kernels=kernels_ms, seconds=seconds)


# The loader-fed adafactor phase: the train phase's model through the
# runner with KFTPU_LOADER=native, a corpus and an eval corpus written here
# from a seed, and optimizer "adafactor".
ADAFACTOR_STEPS = 6
CORPUS_TOKENS = {"train.bin": 4_000_000, "eval.bin": 500_000}
FEED_STEPS = 3


def adafactor_train_phase(adamw_peak: float):
    """The ~700M model trained with adafactor through the runner from a
    token file: KFTPU_LOADER=native, KFTPU_DATA_PATH and
    KFTPU_EVAL_DATA_PATH (int32 corpora in the vocabulary, written from a
    seed), KFTPU_HPARAMS {"optimizer": "adafactor"}, ADAFACTOR_STEPS steps
    and one eval at the end. Checks every step's loss is finite, the
    launches of each step (K11 once, which computes the norm: no K5 norm
    and no K5 update; the rest as the adamw step), that the native loader
    fed the run and the eval,
    and the eval's loss; prints the median synchronised step, MFU, peak
    memory beside the adamw train phase's, the loader's stalls, one
    profiled step's idle share, and the idle share of FEED_STEPS
    loader-fed steps with each batch copied from pageable memory (the
    runner before this slice) and through the runner's pinned DeviceFeed,
    in turns. The corpora go to a temporary directory that is removed
    however it ends."""
    import tempfile

    work = tempfile.mkdtemp(prefix="kftpu-smoke-adafactor-")
    try:
        return _adafactor_runs(work, adamw_peak)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _adafactor_runs(work: str, adamw_peak: float):
    from kubeflow_tpu_torch.models.llama import LlamaConfig
    from kubeflow_tpu_torch.train import native_loader, runner
    from kubeflow_tpu_torch.train.flops import train_flops_per_token
    from kubeflow_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(14)
    V = TRAIN_MODEL_KW["vocab_size"]
    paths = {}
    for name, count in CORPUS_TOKENS.items():
        paths[name] = os.path.join(work, name)
        rng.integers(0, V, count, dtype=np.int32).tofile(paths[name])
    loaders = []
    plain_loader, plain_step = native_loader.NativeTokenLoader, Trainer.step

    class Recorded(plain_loader):
        """The runner's loaders, with their counts kept at close."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.final = None
            loaders.append(self)

        def close(self):
            if self._handle is not None:
                self.final = (self.batches_produced, self.stalls)
            super().close()

    record = []

    def timed_step(self, state, batch):
        for _, obj, attr in fused_counters():
            setattr(obj, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = plain_step(self, state, batch)
        loss = float(metrics["loss"])
        record.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                           last=(self, state, batch), launches={
                               name: getattr(obj, attr)
                               for name, obj, attr in fused_counters()}))
        return state, metrics

    os.environ.update({
        "KFTPU_MODEL": "llama-tiny",
        "KFTPU_MODEL_KW": json.dumps(TRAIN_MODEL_KW),
        "KFTPU_HPARAMS": json.dumps({"optimizer": "adafactor",
                                     "warmup_steps": 2}),
        "KFTPU_BATCH_PER_HOST": str(TRAIN_BATCH),
        "KFTPU_SEQ_LEN": str(TRAIN_SEQ), "KFTPU_ATTN_IMPL": "flash",
        "KFTPU_CHECKPOINT_DIR": "", "KFTPU_TRAIN_STEPS": str(ADAFACTOR_STEPS),
        "KFTPU_LOADER": "native", "KFTPU_DATA_PATH": paths["train.bin"],
        "KFTPU_EVAL_DATA_PATH": paths["eval.bin"],
        "KFTPU_EVAL_EVERY": str(ADAFACTOR_STEPS), "KFTPU_EVAL_BATCHES": "2",
        "KFTPU_TERMINATION_LOG": os.path.join(work, "termination.json"),
    })
    os.environ.pop("KFTPU_PLATFORM", None)          # cuda
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    native_loader.NativeTokenLoader, Trainer.step = Recorded, timed_step
    try:
        runner.run(runner.env_config())
    finally:
        native_loader.NativeTokenLoader, Trainer.step = (plain_loader,
                                                         plain_step)
        for key in ("KFTPU_LOADER", "KFTPU_DATA_PATH", "KFTPU_EVAL_DATA_PATH",
                    "KFTPU_EVAL_EVERY", "KFTPU_EVAL_BATCHES"):
            os.environ.pop(key, None)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(work, "termination.json")) as f:
        report = json.load(f)
    layers = TRAIN_MODEL_KW["num_layers"]
    want = train_launches_per_step(layers, TRAIN_MODEL_KW["remat_policy"],
                                   "adafactor")
    if len(record) != ADAFACTOR_STEPS:
        raise AssertionError(f"adafactor: ran {len(record)} steps")
    for i, r in enumerate(record):
        if r["launches"] != want or not np.isfinite(r["loss"]):
            raise AssertionError(f"adafactor step {i + 1}: loss {r['loss']}"
                                 f", launches {r['launches']}, want {want}")
    if [ldr.token_file for ldr in loaders] != [paths["train.bin"],
                                               paths["eval.bin"]] \
            or any(ldr.final is None for ldr in loaders):
        raise AssertionError("the native loader did not feed the run and "
                             f"its eval: {[x.token_file for x in loaders]}")
    if not np.isfinite(report.get("eval_loss", np.nan)):
        raise AssertionError(f"adafactor eval: {report}")
    produced, stalls = loaders[0].final
    cfg = LlamaConfig(**TRAIN_MODEL_KW)
    step_ms = float(np.median([r["ms"] for r in record[1:]]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    mfu = train_flops_per_token(cfg, TRAIN_SEQ) * tok_s / PEAK_BF16_FLOPS
    launches = sum(r["launches"]["K11 update"] for r in record)
    log(f"train adafactor (native loader, corpus {CORPUS_TOKENS['train.bin']}"
        f" tokens): losses " + " ".join(f"{r['loss']:.4f}" for r in record)
        + f"; eval loss {report['eval_loss']:.4f}; steps " + " ".join(
            f"{r['ms']:.1f}" for r in record) + f" ms, median of 2-"
        f"{ADAFACTOR_STEPS} {step_ms:.1f} ms, MFU {mfu:.4f}; peak device "
        f"memory {peak / 1e9:.2f} GB (adamw train phase "
        f"{adamw_peak / 1e9:.2f} GB); loader {produced} batches, {stalls} "
        f"stalls; K11 {want['K11 update']} launch and K5's norm "
        f"{want['K5 norm']} a step (asserted each step), {launches} in all")
    losses = [r["loss"] for r in record]
    trainer, state, batch = record[-1]["last"]
    record.clear()
    breakdown = train_breakdown(trainer, state, batch)
    feed = feed_idle(trainer, state, paths["train.bin"])
    return dict(step_ms=step_ms, mfu=mfu, peak=peak, stalls=stalls,
                produced=produced, launches=launches, report=report,
                losses=losses, breakdown=breakdown, feed=feed)


def feed_idle(trainer, state, corpus: str) -> dict:
    """FEED_STEPS loader-fed steps under the profiler, no synchronisation
    between them, each batch copied to the card from pageable memory (the
    runner's copy before this slice) or through runner.DeviceFeed (pinned,
    non-blocking), in turns (pageable, pinned, pinned, pageable): wall
    time, device busy time and idle share of each window."""
    from kubeflow_tpu_torch.train import native_loader, runner

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ldr = native_loader.NativeTokenLoader(
        batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ + 1,
        vocab_size=TRAIN_MODEL_KW["vocab_size"], token_file=corpus, seed=1)
    copies = {"pageable": lambda b: {k: torch.as_tensor(v).to("cuda")
                                     for k, v in b.items()},
              "pinned": runner.DeviceFeed(torch.device("cuda"))}
    out = {}
    try:
        for name in ("pageable", "pinned", "pinned", "pageable"):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                st = state
                for _ in range(FEED_STEPS):
                    st, _ = trainer.step(st, copies[name](next(ldr)))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(e.device_time_total for e in prof.key_averages()
                       if _is_kernel(e)) / 1e3
            idle = 1 - busy / wall if busy > 0 else None
            out.setdefault(name, []).append(dict(wall_ms=wall, busy_ms=busy,
                                                 idle=idle))
            log(f"  loader-fed window [{name} copy], {FEED_STEPS} steps: "
                f"wall {wall:.2f} ms, device busy "
                + (f"{busy:.2f} ms, idle share {idle:.4f}" if busy > 0
                   else "not measured (no device events)"))
    finally:
        ldr.close()
    return out


def grad_check():
    """One step's grads of a 2-layer model of the training width, flash
    attention (K1 + K2) against the plain attention, same bf16 weights and
    batch: each parameter's relative error within GRAD_REL_BOUND."""
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.train.data import (
        SyntheticTextConfig,
        synthetic_text,
    )
    from kubeflow_tpu_torch.train.losses import cross_entropy_loss

    with torch.device("cuda"):
        model, _ = get_model("llama-tiny",
                             **dict(TRAIN_MODEL_KW, num_layers=2))
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(next(synthetic_text(SyntheticTextConfig(
        batch_size=2, seq_len=TRAIN_SEQ, vocab_size=32000, seed=5)))[
        "inputs"], device="cuda").long()
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]

    def grads(impl):
        logits = model(tokens[:, :-1], attn_impl=impl)
        loss, _ = cross_entropy_loss(logits, tokens[:, 1:],
                                     z_loss_weight=1e-4)
        return torch.autograd.grad(loss, params)

    rel = {}
    for n, a, b in zip(names, grads("flash"), grads("full")):
        rel[n] = ((a.float() - b.float()).norm()
                  / b.float().norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    log(f"grad check (2 layers, flash vs full, bf16): relative error max "
        f"{rel[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(rel.values()))):.3e} over {len(rel)} "
        f"parameters; bound {GRAD_REL_BOUND}")
    if rel[worst] > GRAD_REL_BOUND:
        raise AssertionError(f"flash vs full grads: {worst} relative error "
                             f"{rel[worst]:.3e} > {GRAD_REL_BOUND}")
    return rel


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
    from kubeflow_tpu_torch.train import native_loader

    t_start = t0 = time.time()
    sources = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
               "decode_attention.cu", "int8_linear.cu", "optimizer.cu",
               "rms_norm.cu", "rope.cu", "cross_entropy.cu", "swiglu.cu",
               "adafactor.cu", "moe.cu")
    # The native loader's library goes beside the kernels (an ignored
    # directory of the checkout), built by g++ alongside them.
    native_cache = os.path.join(_build.BUILD_DIR, "native")
    os.makedirs(native_cache, mode=0o700, exist_ok=True)
    os.environ["KFTPU_NATIVE_CACHE"] = native_cache
    with ThreadPoolExecutor(len(sources) + 1) as pool:  # one nvcc each
        loader_lib = pool.submit(native_loader._build)
        libs = dict(zip(sources, pool.map(_build.build, sources)))
        log(f"native loader: {loader_lib.result()}")
    log(f"build: {', '.join(sources)} and the native loader in "
        f"{time.time() - t0:.1f} s")
    for src, lib in libs.items():
        with open(lib[:-3] + ".log") as f:
            for line in f:
                if "Compiling entry" in line:
                    log(f"  {src}: " + line.strip().split("'")[1])
                elif ("registers" in line or "spill" in line
                      or "arning" in line):
                    log("    " + line.strip())
    # K1: D 64/128 x one or two consumer warpgroups; K2: its dk/dv and dq
    # kernels at D 64/128.
    check_build(libs["flash_attention_fwd.cu"], {"flash_fwd_bf16": 4})
    check_build(libs["flash_attention_bwd.cu"],
                {"flash_bwd_dkdv_bf16": 2, "flash_bwd_dq_bf16": 2})
    # K3: D 64/128 x G 1/2/4/8 x bf16/int8 cache x dense/paged, each fed
    # by TMA (its products are mma.sync, HMMA, not wgmma).
    check_build(libs["decode_attention.cu"], {"decode_attn": 32},
                required=("UTMALDG", "HMMA"))
    # K4: the decode kernel at 8 or 16 tokens, per-row or per-column
    # scales, and with the SwiGLU epilogue (per-row scales): mma.sync
    # (HMMA) fed by cp.async (LDGSTS); the prefill kernel at 64, 128 or 256
    # tokens a tile, per-row or per-column scales: wgmma (HGMMA) fed by
    # TMA (UTMALDG).
    check_build(libs["int8_linear.cu"], {"int8_linear_decode": 6},
                required=("HMMA", "LDGSTS"))
    check_build(libs["int8_linear.cu"], {"int8_linear_prefill": 6})
    # K5-K14: element-wise, row and index kernels (no tensor cores); no
    # spills.
    for src in sources[4:]:
        check_build(libs[src], {})
    seconds = {"build": time.time() - t0}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        seconds[name] = time.time() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    rows, max_err = phase("K1", kernel_phase)
    bwd_rows, bwd_err = phase("K2", backward_phase)
    dec_rows, dec_long, dec_paged, dec_err = phase("K3", decode_phase)
    k4_rows, k4_err, k4_step = phase("K4", int8_phase)
    fused_rows = phase("K5-K10", fused_phase)
    k11_row = phase("K11", adafactor_phase)
    moe_rows = phase("K12-K14", moe_phase)
    serve = phase("serve bf16", serve_phase, "", "", True)
    serve_int8 = phase("serve int8 KV", serve_phase, "int8")
    serve_w8 = phase("serve int8 weights", serve_phase, "", "int8")
    serve_paged = phase("serve paged", serve_paged_phase)
    serve_fused = phase("serve fused int8 weights", serve_fused_phase)
    serve_moe = phase("serve mixtral", serve_mixtral_phase)
    for name, s in (("bf16 KV cache", serve), ("int8 KV cache", serve_int8),
                    ("int8 weights, bf16 KV cache", serve_w8)):
        w = s["warm"]
        e = s["extend"]
        log(f"serve summary [{name}]: cold burst {s['tok_s']:.1f} "
            f"tok/s, p50 TTFT {s['ttft_p50'] * 1e3:.1f} ms (700-token "
            f"request {s['ttft_long'] * 1e3:.1f} ms), peak device "
            f"memory {s['peak'] / 1e9:.2f} GB; warm burst {w['tok_s']:.1f} "
            f"tok/s, p50 TTFT {w['ttft_p50'] * 1e3:.1f} ms (700-token "
            f"{w['ttft_long'] * 1e3:.1f} ms), peak "
            f"{w['peak'] / 1e9:.2f} GB; weights {s['weight_bytes'] / 1e9:.2f}"
            f" GB; decode {s['step_ms']:.3f} ms/step "
            f"unprofiled, profiled chunk idle share "
            + ("not measured" if s["idle"] is None else f"{s['idle']:.3f}")
            + f"; extend chunk (C=512) eager {e['eager_warm_ms']:.3f} / "
            f"{e['eager_cold_ms']:.3f} ms, graphed {e['graphed_warm_ms']:.3f}"
            f" / {e['graphed_cold_ms']:.3f} ms (warm / cold)")
    for paged in (True, False):
        e = serve_paged[paged]["extend"]
        log(f"serve summary [{'paged pool' if paged else 'dense cache'}, "
            f"paged phase's config]: extend chunk (C=128) eager "
            f"{e['eager_warm_ms']:.3f} / {e['eager_cold_ms']:.3f} ms, "
            f"graphed {e['graphed_warm_ms']:.3f} / "
            f"{e['graphed_cold_ms']:.3f} ms (warm / cold)")
    train = phase("train", train_phase)
    policies = phase("train fused/policies", train_policies_phase)
    ada = phase("train adafactor", adafactor_train_phase, train["peak"])
    phase("grad check", grad_check)
    log("train summary [unfused, qkv_attn]: median step "
        f"{train['step_ms_median']:.1f} ms, MFU {train['mfu']:.4f}, peak "
        f"{train['peak'] / 1e9:.2f} GB; [fused] " + "; ".join(
            f"{p} {r['step_ms']:.1f} ms, MFU {r['mfu']:.4f}, peak "
            f"{r['peak'] / 1e9:.2f} GB" for p, r in policies.items()))
    def share(x):
        return "not measured" if x is None else f"{x:.4f}"

    bd = ada["breakdown"]
    feed = {k: (None if any(w["idle"] is None for w in v)
                else float(np.mean([w["idle"] for w in v])))
            for k, v in ada["feed"].items()}
    log(f"train summary [adafactor, native loader, qkv_attn]: median step "
        f"{ada['step_ms']:.1f} ms, MFU {ada['mfu']:.4f}, peak "
        f"{ada['peak'] / 1e9:.2f} GB (adamw {train['peak'] / 1e9:.2f}), "
        f"loader stalls {ada['stalls']}, profiled step idle share "
        + share(1 - bd["busy_ms"] / bd["wall_ms"] if bd["busy_ms"] > 0
                else None)
        + "; loader-fed windows' idle share, pageable copy "
        + share(feed["pageable"]) + ", pinned DeviceFeed "
        + share(feed["pinned"]))
    log("serve summary [fused, int8 weights]: decode "
        f"{serve_fused['fused']['step_ms']:.3f} ms/step (unfused, same "
        f"weights: {serve_fused['unfused']['step_ms']:.3f}); burst "
        f"{serve_fused['fused']['tok_s']:.1f} tok/s (unfused "
        f"{serve_fused['unfused']['tok_s']:.1f}); "
        f"{serve_fused['differ']} requests' tokens differ")
    log(f"serve summary [mixtral-8x7b, {MIXTRAL_LAYERS} layers]: decode "
        f"{serve_moe['step_ms']:.3f} ms/step (byte bound "
        f"{serve_moe['bound_ms']:.2f}), burst {serve_moe['tok_s']:.1f} tok/s,"
        f" peak {serve_moe['peak'] / 1e9:.2f} GB, weights "
        f"{serve_moe['weight_bytes'] / 1e9:.2f} GB, phase "
        f"{serve_moe['seconds']:.1f} s")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      seconds.items())
        + f"; total {time.time() - t_start:.1f}")
    main_row = next(r for r in rows if r["case"] == "causal_b8_s512")
    train_row = next(r for r in rows if r["case"] == "causal_b12_s2048_h16")
    bwd_row = next(r for r in bwd_rows if r["case"] == "train_b12_s2048")

    def entry(name, source, replaces, n, err, row):
        return {"name": name, "route": "cuda",
                "source": f"kubeflow_tpu_torch/ops/csrc/{source}",
                "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    fwd = entry("flash_attention_fwd", "flash_attention_fwd.cu",
                "kubeflow_tpu/ops/flash_attention.py:115", serve["k1"],
                max_err, main_row)
    fwd.update({f"train_{key}": train_row[key]
                for key in ("ms", "library_ms", "bound_ms")})
    # K1 at the chunked-prefill extend's shapes (and, in front of it with
    # an int8 cache, the gather and dequantization of one layer's K and V).
    for row in rows:
        if row["case"].startswith(("extend", "gather", "dequant")):
            fwd.update({f"{row['case']}_{key}": row[key]
                        for key in ("ms", "bound_ms", "library_ms")
                        if key in row})
    bwd = entry("flash_attention_bwd", "flash_attention_bwd.cu",
                "kubeflow_tpu/ops/flash_attention.py:265", train["bwd"],
                bwd_err, bwd_row)
    bwd.update({key: bwd_row[key]
                for key in ("dkdv_ms", "dq_ms", "split_bound_ms")})
    # K3 at the case the served path runs (staged, bf16 cache), cold (each
    # call on other cache rows, as in the served step), its warm time
    # beside it; its other cases under prefixes, SDPA's times at the
    # unstaged bf16 one; the long context (L = 8192) under l8192_.
    dec = {r["case"]: r for r in dec_rows}
    k3 = entry("decode_attention", "decode_attention.cu",
               "kubeflow_tpu/models/llama.py:337", serve["k3"], dec_err,
               dec["bf16_staged"])
    k3["warm_ms"] = dec["bf16_staged"]["warm_ms"]
    k3["int8_launches"] = serve_int8["k3"]
    k3["chunk_launches"] = serve["k3_chunk_launches"]
    for case in ("bf16", "int8", "int8_staged"):
        prefix = {"bf16": "unstaged_", "int8": "int8_",
                  "int8_staged": "int8_staged_"}[case]
        k3.update({prefix + key: dec[case][key]
                   for key in ("ms", "warm_ms", "plain_ms", "bound_ms",
                               "library_ms", "library_warm_ms")})
    for row in dec_long:
        prefix = row["case"].replace("_staged", "") + "_"
        k3.update({prefix + key: row[key]
                   for key in ("ms", "bound_ms", "max_abs_err")})
    # K3 by block table (paged_bf16_, paged_int8_), cold, beside the dense
    # call over the same rows; its launches in the paged bursts.
    for row in dec_paged:
        prefix = row["case"].replace("_staged", "") + "_"
        k3.update({prefix + key: row[key]
                   for key in ("ms", "dense_ms", "plain_ms", "bound_ms",
                               "max_abs_err")})
    k3["paged_launches"] = serve_paged[True]["a"]["k3"]
    # K4 at the gate shape, M = 8 (the decode step's), cold; its warm time
    # and its yardstick (F.linear on bf16 weights, cold and warm) beside
    # it; the other products under their names, the gate shape at
    # other token counts under gate_m<M>_.
    k4_by = {r["case"]: r for r in k4_rows}
    k4 = entry("int8_linear", "int8_linear.cu",
               "kubeflow_tpu/serving/engine.py:1362", serve_w8["k4"], k4_err,
               k4_by["gate_proj"])
    k4.update(warm_ms=k4_by["gate_proj"]["warm_ms"],
              library_warm_ms=k4_by["gate_proj"]["library_warm_ms"],
              chunk_launches=serve_w8["k4_chunk_launches"],
              chunk_ms=serve_w8["k4_chunk_ms"])
    for kind, sums in k4_step.items():
        k4.update({f"step_{kind}_{key}": v for key, v in sums.items()})
    for case, row in k4_by.items():
        if case != "gate_proj":
            k4.update({f"{case}_{key}": row[key]
                       for key in ("ms", "warm_ms", "plain_ms", "bound_ms",
                                   "library_ms", "group_ms", "group_k9_ms")
                       if key in row})
    # The SwiGLU epilogue's launches in the 8-slot int8-weight burst.
    k4["swiglu_launches"] = serve_w8["k4e"]
    # K5-K8 at the train step's shapes; launches over the 10-step run;
    # their device ms in the profiled step under step_ms; K6 and K7 at the
    # serving shapes under decode_ and prefill_, with the bf16 burst's
    # launches (graph replays counted).
    tf, step_k = train["fused"], train["breakdown"]["by_kernel"]

    def fused_entry(tag, name, source, replaces, launches, row):
        e = {"name": name, "route": "cuda",
             "source": f"kubeflow_tpu_torch/ops/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": "bytes", "library_ms": row["library_ms"],
             "step_ms": step_k[tag][0], "step_kernels": step_k[tag][1]}
        e.update({key: v for key, v in row.items() if key not in e})
        return e

    k5 = fused_entry("K5", "optimizer_update", "optimizer.cu",
                     "kubeflow_tpu/train/trainer.py:132",
                     tf["K5 norm"] + tf["K5 update"], fused_rows["K5"]["train"])
    k6 = fused_entry("K6", "rms_norm", "rms_norm.cu",
                     "kubeflow_tpu/ops/norms.py:9",
                     tf["K6 forward"] + tf["K6 backward"],
                     fused_rows["K6"]["train"])
    k7 = fused_entry("K7", "rope", "rope.cu", "kubeflow_tpu/ops/rope.py:21",
                     tf["K7 forward"] + tf["K7 backward"],
                     fused_rows["K7"]["train"])
    for k, tag in ((k6, "K6"), (k7, "K7")):
        for case, row in fused_rows[tag].items():
            if case != "train":
                k.update({f"{case}_{key}": v for key, v in row.items()})
    # K7's strided mode (the fused q/k/v projection read in place) under
    # strided_<case>_, its staged mode under stage_<case>_; the staged
    # launches of the bf16 burst and the staged launch's us in each serve
    # phase's profiled decode chunk.
    k6["serve_launches"], k7["serve_launches"] = serve["k6"], serve["k7"]
    k7["stage_launches"] = serve["k7s"]
    k7["paged_stage_launches"] = serve_paged[True]["a"]["k7s"]
    k8 = fused_entry("K8", "cross_entropy", "cross_entropy.cu",
                     "kubeflow_tpu/train/losses.py:11",
                     tf["K8 forward"] + tf["K8 backward"],
                     fused_rows["K8"]["train"])
    # K9 and K10 at the train step's shapes (K9 with gate and up apart,
    # as the unfused train phase runs it; the fused layout under
    # train_fused_); launches over the unfused train phase's 10 steps;
    # serving shapes under decode_ and prefill_.
    k9 = fused_entry("K9", "swiglu", "swiglu.cu",
                     "kubeflow_tpu/models/llama.py:657",
                     tf["K9 forward"] + tf["K9 backward"],
                     fused_rows["K9"]["train"])
    k10 = fused_entry("K10", "add_rms_norm", "rms_norm.cu",
                      "kubeflow_tpu/models/llama.py:677",
                      tf["K10 forward"] + tf["K10 backward"],
                      fused_rows["K10"]["train"])
    for k, tag in ((k9, "K9"), (k10, "K10")):
        for case, row in fused_rows[tag].items():
            if case != "train":
                k.update({f"{case}_{key}": v for key, v in row.items()})
        k["serve_launches"] = serve[tag.lower()]
    k9["int8_weights_launches"] = serve_w8["k9"]
    k9["paged_launches"] = serve_paged[True]["a"]["k9"]
    # K10's rows kernel, K7's staged launch and K9 a launch in each serve
    # phase's profiled decode chunk (K9 none with the epilogue).
    for case, st in (("bf16", serve), ("int8_kv", serve_int8),
                     ("int8_weights", serve_w8),
                     ("paged", serve_paged[True])):
        k10[f"chunk_{case}_us"] = st["k10_chunk_us"]
        k7[f"chunk_{case}_stage_us"] = st["k7s_chunk_us"]
        k9[f"chunk_{case}_us"] = st["k9_chunk_us"]
    # K11 over the 700M model's tensors (scanned leaves); launches over the
    # loader-fed adafactor run; its device ms in that run's profiled step.
    ada_k = ada["breakdown"]["by_kernel"]["K11"]
    k11 = {"name": "adafactor_update", "route": "cuda",
           "source": "kubeflow_tpu_torch/ops/csrc/adafactor.cu",
           "replaces": "kubeflow_tpu/train/trainer.py:146",
           "launches": ada["launches"], "max_abs_err": k11_row["max_abs_err"],
           "ms": k11_row["ms"], "plain_ms": k11_row["plain_ms"],
           "bound_ms": k11_row["bound_ms"], "bound_by": "bytes",
           "library_ms": k11_row["library_ms"], "step_ms": ada_k[0],
           "step_kernels": ada_k[1]}
    k11.update({key: v for key, v in k11_row.items() if key not in k11})
    # K12-K14 at the served decode step's shape (8 rows), the prefill
    # group's (4096) under prefill_; launches over the mixtral burst, and
    # the kernels and device ms in its profiled decode chunk.
    moe_entries = []
    for (tag, name, line), launches in zip(
            (("K12", "moe_route", 57), ("K13", "moe_gather", 159),
             ("K14", "moe_combine", 187)), serve_moe["launches"]):
        row = moe_rows[tag]["decode"]
        e = {"name": name, "route": "cuda",
             "source": "kubeflow_tpu_torch/ops/csrc/moe.cu",
             "replaces": f"kubeflow_tpu/parallel/moe.py:{line}",
             "launches": launches, "max_abs_err": row["max_abs_err"],
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]}
        e.update({f"prefill_{key}": v
                  for key, v in moe_rows[tag]["prefill"].items()})
        e["chunk_kernels"], e["chunk_ms"] = serve_moe["chunk_kernels"][tag]
        moe_entries.append(e)
    print(json.dumps({"kernels": [fwd, bwd, k3, k4, k5, k6, k7, k8, k9,
                                  k10, k11, *moe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

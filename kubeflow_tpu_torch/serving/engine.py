"""Continuous-batching generation engine over a dense KV cache, the port
of kubeflow_tpu.serving.engine.

- A fixed slot batch decodes ``decode_chunk`` tokens per dispatch;
  sequences join and leave slots between dispatches.
- Admission groups waiting prompts by bucket (powers of two) and
  prefills each group in one dispatch: fresh cache rows, the forward in
  ``decode="prefill"`` mode (attention through the flash kernel), the
  rows installed at the group's slots, then the lm_head on each row's
  last position only.
- Prompts longer than the largest bucket stream through bucket-wide
  chunked prefill (``_extend_step``), so any prompt up to max_len - 1
  serves.
- Sampling (greedy / temperature / top-k / top-p over a static
  ``sample_candidates`` set, logprobs) runs on the device; only token ids
  cross to the host.
- ``run()`` keeps ``pipeline_depth`` decode dispatches in flight, the
  next chained off the previous one's device-resident last tokens.
- With a staging model (``LlamaConfig.decode_staging`` >= ``decode_chunk``)
  each decode step writes its k/v into per-chunk staging rows, and the
  chunk ends with one flush into the cache (``_flush_staging``); an int8
  KV cache (``kv_cache_dtype="int8"``) quantizes rows at the write or the
  flush.
- On the card each decode chunk (every step plus the flush), each
  grouped prefill ``(bucket, k_pad)`` and each chunked-prefill chunk
  width run as captured CUDA graphs, one per sampling variant, as the JAX
  engine compiles each into one XLA program (see ``_Graph``); the CPU
  path runs the same steps eagerly.
- ``quantize="int8"`` serves weight-only int8 projections
  (``_quantize_int8``): every product of every step, and the lm_head,
  reads the int8 bytes through ``ops/int8_linear.py`` (K4 on the card);
  the fused ``qkv_proj`` and ``gate_up_proj`` (``LlamaConfig.fused_qkv``,
  ``fused_gate_up``) quantize one scale an output row, as the JAX engine
  quantizes them over their contraction axis, and run one product each.
  A Mixtral's expert leaves quantize over their expert axis (one scale an
  element, as the JAX engine's) and run through ``ops/int8_experts.py``
  (K15). :func:`init_int8` builds a random int8 model leaf by leaf, as
  the JAX engine's random-init int8 server does.
- A model built with ``paged_kv_blocks`` serves from the physically paged
  pool (``ops/paged_attention.py``): one pool per layer addressed through
  per-slot block tables from ``serving/blocks.py``. Prompts with a common
  block-aligned head map it to the same pages (an identical prompt also
  its partial tail page), and the first decode write into a shared page
  forks it (copy-on-write, ``_cow_prepare``). On the card, K3 reads the
  pool in place through one persistent device table that the captured
  graphs read.

Positions follow the JAX engine exactly, including its decode RoPE
positions, which run one past the cache slot they are written to
(``_Slot.pos`` counts the prefill's first token before it is fed back):
greedy tokens match the JAX engine's, and a full re-forward reproduces
them only with the same positions.

Out of scope in this slice (each raises NotImplementedError): mesh
serving and the step profiler.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import hashlib
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import (
    Dense,
    Int8Dense,
    Llama,
    Paging,
    quantize_kv_rows,
)
from kubeflow_tpu_torch.models.mixtral import (
    EXPERT_LEAVES,
    Int8Experts,
    MoeMlp,
)
from kubeflow_tpu_torch.ops.decode_attention import decode_attention
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.int8_experts import int8_experts
from kubeflow_tpu_torch.ops.int8_linear import int8_linear
from kubeflow_tpu_torch.ops.moe import combine_rows, gather_rows, route
from kubeflow_tpu_torch.ops.norms import add_rms_norm, rms_norm
from kubeflow_tpu_torch.ops.paged_attention import (
    copy_block,
    physical_rows,
    scatter_kv_rows,
    scratch_block_id,
)
from kubeflow_tpu_torch.ops.rope import apply_rope
from kubeflow_tpu_torch.ops.swiglu import swiglu
from kubeflow_tpu_torch.serving.blocks import (
    BlocksExhausted,
    KVBlockAllocator,
    blocks_for_tokens,
    prefix_chain,
    prefix_key,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.monitoring import (
    MetricsRegistry,
    global_registry,
    nearest_rank_quantile,
)

#: Serving-path latency buckets (seconds).
SERVING_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Only queue waits observed inside this window feed the load() p50/p95.
LOAD_WINDOW_S = 60.0

#: Per-slot cache leaves [B, max_len, ...] (the scales with an int8 cache);
#: in paged mode the pool leaves [P + 1, block_size, ...].
_ROW_LEAVES = ("cached_key", "cached_value", "key_scale", "value_scale")


class EngineOverloaded(RuntimeError):
    """submit() refused: the request queue is at ``ServingConfig.max_queue``.
    ``retry_after_s`` is the engine's estimate of one queue drain (>= 1s);
    the server maps this to HTTP 429 + Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(1.0, float(retry_after_s))


@dataclasses.dataclass
class GenerationRequest:
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => no top-k restriction
    top_p: float = 1.0                # 1.0 => no nucleus restriction
    eos_token: Optional[int] = None
    session: str = ""                 # LB cache-affinity key ("s:<id>")
    request_id: int = 0
    submitted_at: float = 0.0


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    tokens: List[int]
    prompt_len: int
    finished_reason: str = "length"   # "length" | "eos"
    latency_s: float = 0.0
    ttft_s: float = 0.0               # time to first token
    # log_softmax(logits)[token] per generated token (temperature-free).
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 8
    max_len: int = 1024
    prefill_buckets: tuple = (32, 64, 128, 256, 512)
    # Cast float params to this dtype at engine start ("" keeps them).
    param_dtype: str = "bfloat16"
    # Weight-only quantization: "int8" stores the projections (the
    # embedding excluded) as int8 with bf16 scales, and every product reads
    # them through ops/int8_linear.py; "" keeps the weights as they are.
    quantize: str = ""
    # Leaves below this element count stay unquantized; tests lower it to
    # exercise the path on tiny models.
    quantize_min_size: int = 65536
    # Tokens decoded per dispatch.
    decode_chunk: int = 1
    # Decode dispatches kept in flight by run(); each chains off the
    # previous one's last tokens on the device. Costs up to
    # (depth - 1) * decode_chunk speculative tokens per finished sequence.
    pipeline_depth: int = 2
    # Candidate-set size for top-k/top-p sampling (larger top_k clamps).
    sample_candidates: int = 64
    # submit() raises EngineOverloaded once this many requests wait
    # (0 = unbounded).
    max_queue: int = 0
    # KV capacity accounting in blocks of this many positions: admission
    # claims prompt + max_new_tokens worth of blocks and frees them at
    # retirement. 0 blocks = the dense equivalent (never refuses a slot).
    kv_block_size: int = 16
    kv_blocks: int = 0
    # Per-token logprobs in results (off by default: an extra logsumexp
    # over the vocab per step).
    logprobs: bool = False

    def __post_init__(self):
        if self.quantize not in ("", "int8"):
            raise ValueError(f"unsupported quantize={self.quantize!r} "
                             "(\"int8\" or \"\")")


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-undrained decode chunk."""
    out: torch.Tensor                    # [B, K] device tokens
    lps: torch.Tensor                    # [B, K] device logprobs
    positions: np.ndarray                # [B, 1] positions at dispatch
    snapshot: list                       # slot objects active at dispatch


class _Slot:
    __slots__ = ("req", "generated", "logprobs", "pos", "first_token_at")

    def __init__(self, req: GenerationRequest):
        self.req = req
        self.generated: List[int] = []
        self.logprobs: List[float] = []
        self.pos = len(req.prompt)
        self.first_token_at: Optional[float] = None


#: The Python launch counters of the kernels a captured step holds
#: (K1's forward, K3, K4 and its SwiGLU epilogue, and the forwards of K6,
#: K7 and its staged mode, K9 and K10, with those of K6 and K10 through
#: their rows kernels and K10's combine mode; a MoE model's K12-K15 and
#: K15's fused gate/up launch): a
#: replay launches without running Python, so each graph counts its
#: captured launches once and adds them per replay.
_LAUNCH_COUNTERS = ((flash_attention, "fwd_launches"),
                    (decode_attention, "launches"),
                    (int8_linear, "launches"),
                    (int8_linear, "swiglu_launches"),
                    (rms_norm, "fwd_launches"),
                    (apply_rope, "fwd_launches"),
                    (apply_rope, "stage_launches"),
                    (swiglu, "fwd_launches"),
                    (add_rms_norm, "fwd_launches"),
                    (rms_norm, "rows_launches"),
                    (add_rms_norm, "rows_launches"),
                    (add_rms_norm, "combine_launches"),
                    (route, "launches"),
                    (gather_rows, "launches"),
                    (combine_rows, "launches"),
                    (int8_experts, "launches"),
                    (int8_experts, "swiglu_launches"))


def _launch_counts() -> List[int]:
    return [getattr(fn, name) for fn, name in _LAUNCH_COUNTERS]


def _add_launches(deltas: List[int]) -> None:
    for (fn, name), d in zip(_LAUNCH_COUNTERS, deltas):
        setattr(fn, name, getattr(fn, name) + d)


def _quantizable(name: str, p: torch.Tensor, min_size: int) -> bool:
    """The JAX engine's ``_quantizable`` on the port's parameter names:
    floating leaves of ndim >= 2 and at least ``min_size`` elements, no
    name part containing "embed". So the projections and the lm_head
    quantize; the embedding, the norms and small leaves do not."""
    return (p.is_floating_point() and p.dim() >= 2
            and p.numel() >= min_size
            and not any("embed" in part for part in name.split(".")))


def _quantize_leaf(w: torch.Tensor, period: int):
    """The JAX engine's ``_quantize_leaf`` on a port weight [out, in]:
    symmetric int8 with scale = max(amax / 127, 1e-12) in f32, amax over
    the in-features that share a scale, q = clip(round(x / scale), -127,
    127) with the f32 scale, which is then stored as bf16. ``period`` S:
    in-feature k shares the scale of k mod S. S = 1 reduces over all of
    K, as over axis 0 of a JAX kernel [in, out...]; o_proj's JAX kernel
    [H, Dh, E] reduces over its heads only, so its weight [E, H * Dh] takes
    S = head_dim. Returns (int8 [out, in], bf16 [out, S]); no copy of
    ``w`` beyond one f32 leaf and its quotient is made."""
    out, inn = w.shape
    x = w.detach().float().view(out, inn // period, period)
    amax = torch.maximum(x.amax(dim=1, keepdim=True),
                         -x.amin(dim=1, keepdim=True))        # = max |x|
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q.view(out, inn), scale.view(out, period).to(torch.bfloat16)


def _quantize_expert_leaf(w: torch.Tensor):
    """The JAX engine's ``_quantize_leaf(x, 0)`` on a MoE expert leaf [E,
    K, N]: it quantizes an unstacked leaf over its axis 0, which here is
    the expert axis, so every element has its own scale, shared by the
    experts: amax over the experts, scale = max(amax / 127, 1e-12) in f32,
    q = clip(round(x / scale), -127, 127) with the f32 scale, which is
    then stored as bf16. Returns them transposed, K contiguous, as
    :class:`Int8Experts` holds them: (int8 [E, N, K], bf16 [1, N, K])."""
    x = w.detach().to(torch.float32, copy=True)
    amax = torch.maximum(x.amax(dim=0, keepdim=True),
                         -x.amin(dim=0, keepdim=True))        # = max |x|
    scale = (amax / 127.0).clamp_min(1e-12)
    q = x.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    del x
    return (q.transpose(1, 2).contiguous(),
            scale.to(torch.bfloat16).transpose(1, 2).contiguous())


@torch.no_grad()
def _quantize_param(model: Llama, name: str, p: torch.Tensor,
                    min_size: int) -> bool:
    """Quantize parameter ``name`` of ``model`` (``p``, its values) IN
    PLACE if it is ``_quantizable``: a :class:`Dense` weight becomes an
    :class:`Int8Dense`, a :class:`MoeMlp` expert leaf an
    :class:`Int8Experts`. Returns whether it did."""
    if not _quantizable(name, p, min_size):
        return False
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    if isinstance(owner, Dense) and leaf == "weight":
        parent_name, _, child = owner_name.rpartition(".")
        period = model.cfg.head_dim if child == "o_proj" else 1
        q, scale = _quantize_leaf(p, period)
        setattr(model.get_submodule(parent_name), child,
                Int8Dense(q, scale, model.cfg))
    elif isinstance(owner, MoeMlp) and leaf in EXPERT_LEAVES:
        q, scale = _quantize_expert_leaf(p)
        delattr(owner, leaf)
        setattr(owner, leaf, Int8Experts(q, scale, model.cfg))
    else:
        raise ValueError(f"{name}: only Dense projections and MoE expert "
                         f"leaves quantize, not {type(owner).__name__}")
    return True


def quantized_names(model: Llama) -> List[str]:
    """The names of ``model``'s int8 weights: each :class:`Int8Dense`'s
    ``<module>.weight`` and each :class:`Int8Experts` leaf's name, the
    parameters they took the place of."""
    return [f"{n}.weight" if isinstance(m, Int8Dense) else n
            for n, m in model.named_modules()
            if isinstance(m, (Int8Dense, Int8Experts))]


@torch.no_grad()
def _quantize_int8(model: Llama, min_size: int = 65536) -> List[str]:
    """Replace every :class:`Dense` whose weight is ``_quantizable`` by an
    :class:`Int8Dense` and every such expert leaf by an
    :class:`Int8Experts`, IN PLACE and one leaf at a time: each bf16
    weight is freed before the next is quantized, so the peak is the model
    plus one leaf's f32 copies. The model must be unrolled-equivalent (the
    port always is): the JAX engine's stacked (``scan_layers=True``) tree
    would quantize its [L, E] norm leaves across layers, which this does
    not reproduce. Returns :func:`quantized_names` (a model built by
    :func:`init_int8` has them already)."""
    names = [n for n, p in model.named_parameters()
             if _quantizable(n, p, min_size)]
    for name in names:
        _quantize_param(model, name, model.get_parameter(name), min_size)
    return quantized_names(model)


@torch.no_grad()
def init_int8(model: Llama, generator: torch.Generator,
              min_size: int = 65536) -> List[str]:
    """The streaming int8 build, the port's counterpart of the JAX
    engine's ``_surrogate_quantized``: ``model``, built on the meta
    device, gets each parameter in :meth:`Llama.init_weights`' order, made
    on the generator's device in its own dtype, initialised as
    ``init_weights`` does (:meth:`Llama.init_param`) and, if
    ``_quantizable``, quantized (:func:`_quantize_param`) before the next
    one is made. So no full-precision leaf but the one being quantized is
    resident beside the int8 model (mixtral-8x7b: ~58 GB where its bf16
    weights are ~93 GB), and from the same generator the int8 weights and
    scales are bitwise those of ``init_weights`` then
    :func:`_quantize_int8`. Returns :func:`quantized_names`."""
    for name, p in list(model.named_parameters()):
        t = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
        Llama.init_param(name, t, generator)
        if not _quantize_param(model, name, t, min_size):
            owner_name, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner_name), leaf,
                    torch.nn.Parameter(t, requires_grad=False))
        del t
    return quantized_names(model)


def sampling_variant(samp: np.ndarray) -> str:
    """The sampler branch a host [B, 3] (temperature, top_k, top_p) array
    needs: "greedy" (no row samples), "restricted" (a sampled row asks for
    top-k or top-p) or "plain". The JAX step picks these with lax.cond
    inside one program; the port picks on the host, and captures one
    graph per variant."""
    temps, ks, ps = samp[:, 0], samp[:, 1], samp[:, 2]
    if not np.any(temps > 0):
        return "greedy"
    if np.any((temps > 0) & ((ks > 0) | (ps < 1.0))):
        return "restricted"
    return "plain"


class _Graph:
    """One engine step captured as a CUDA graph: the static device buffers
    its inputs are copied into before each replay, its outputs, and the
    kernel launches it holds.

    Hazards, each held by a card test (tests/test_torch_cuda.py):

    - **Outputs are overwritten by the next replay.** Chained decode
      (``pipeline_depth`` 2) feeds a dispatch's last tokens to the next
      one and reads its tokens after the next one is queued, so
      :meth:`replay` hands back device COPIES of the outputs, one set per
      dispatch, made on the stream before any later replay.
    - **Graphs share one memory pool.** One graph's replay may reuse
      memory another graph's outputs occupied at capture. The copies above
      are made before any other replay, so no graph's output is ever read
      after another graph runs; inputs live outside the pool.
    - **The sampler's generator.** A sampled variant's graph registers the
      engine's ``torch.Generator`` before capture, so every replay draws
      fresh Gumbel noise (advancing the generator) instead of repeating
      the captured draw, and the engine's seed reproduces the sequence.
    - **Python counters do not count replays.** The launches counted
      while capturing are taken back out of the counters and added again
      on every replay (``_LAUNCH_COUNTERS``).
    """

    def __init__(self, graph, inputs: Dict[str, torch.Tensor], outputs,
                 launches: List[int]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches

    def replay(self, **inputs: torch.Tensor):
        for name, src in inputs.items():
            self.inputs[name].copy_(src, non_blocking=True)
        self.graph.replay()
        _add_launches(self.launches)
        return tuple(o.clone() for o in self.outputs)


class ServingEngine:
    """Serves ``model`` (its own parameters) on ``device`` — ``cuda``
    unless the caller asks for ``"cpu"``. The engine casts the model's
    floating parameters to ``cfg.param_dtype`` IN PLACE (a copy would
    double the weights' device memory), turns their gradients off and,
    with ``cfg.quantize="int8"``, swaps its projections for int8 ones
    (``_quantize_int8``; the model is changed in place).

    On the card the decode chunk, the grouped prefill and the
    chunked-prefill chunk run as CUDA graphs; ``_eager=True`` runs them
    eagerly instead (the card tests hold the graphs' tokens against
    it)."""

    def __init__(
        self,
        model: Llama,
        cfg: ServingConfig,
        *,
        device: DeviceLike = None,
        registry: MetricsRegistry = global_registry,
        mesh=None,
        profiler=None,
        _eager: bool = False,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (the multi-GPU slice)")
        if profiler is not None:
            raise NotImplementedError(
                "the step profiler hook is not ported yet (the tooling "
                "slice)")
        if model.cfg.max_seq_len < cfg.max_len:
            raise ValueError(
                f"model max_seq_len {model.cfg.max_seq_len} < engine max_len "
                f"{cfg.max_len}"
            )
        if cfg.decode_chunk < 1:
            raise ValueError(f"decode_chunk {cfg.decode_chunk} must be >= 1")
        staging = model.cfg.decode_staging
        if staging and staging < cfg.decode_chunk:
            # A chunk longer than the staging rows would wrap and overwrite
            # rows not yet flushed.
            raise ValueError(
                f"model decode_staging {staging} < engine decode_chunk "
                f"{cfg.decode_chunk}")
        self._paged = model.cfg.paged_kv_blocks > 0
        if self._paged:
            # The allocator's ledger and the physical pool must be the same
            # blocks, or the rows the tables address do not exist.
            if model.cfg.scan_layers:
                raise ValueError(
                    "paged_kv_blocks requires scan_layers=False (the "
                    "serving layout)")
            if model.cfg.paged_kv_block_size != cfg.kv_block_size:
                raise ValueError(
                    f"model paged_kv_block_size "
                    f"{model.cfg.paged_kv_block_size} != engine "
                    f"kv_block_size {cfg.kv_block_size}")
            if cfg.kv_blocks != model.cfg.paged_kv_blocks:
                raise ValueError(
                    f"engine kv_blocks {cfg.kv_blocks} != model pool "
                    f"paged_kv_blocks {model.cfg.paged_kv_blocks}: the "
                    "accounting ledger and the physical pool must be the "
                    "same blocks")
            if cfg.max_len % cfg.kv_block_size != 0:
                raise ValueError(
                    f"paged serving needs max_len {cfg.max_len} divisible "
                    f"by kv_block_size {cfg.kv_block_size} (the dense-vs-"
                    "paged exactness contract; see ops/paged_attention.py)")
        self.device = resolve_device(device)
        self._staging = staging > 0
        self._graphed = self.device.type == "cuda" and not _eager
        self._graphs: Dict[tuple, _Graph] = {}
        self._graph_pool = None
        self._capture_stream = (torch.cuda.Stream(self.device)
                                if self._graphed else None)
        self.model = model
        self.cfg = cfg
        self._queue: Deque[GenerationRequest] = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * cfg.max_batch
        self._results: Dict[int, GenerationResult] = {}
        self._req_ids = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.metrics_queue_wait = registry.histogram(
            "kftpu_serving_queue_wait_seconds",
            "Request wait between submit and slot admission",
            buckets=SERVING_LATENCY_BUCKETS,
        )
        self.metrics_ttft = registry.histogram(
            "kftpu_serving_ttft_seconds",
            "Time to first generated token (includes queue wait)",
            buckets=SERVING_LATENCY_BUCKETS,
        )
        self.metrics_per_token = registry.histogram(
            "kftpu_serving_per_token_seconds",
            "Mean decode time per generated token after the first",
            buckets=SERVING_LATENCY_BUCKETS,
        )
        self.metrics_requests = registry.counter(
            "kftpu_serving_requests_total",
            "Engine admission outcomes",
            labels=("outcome",),
        )
        self._recent_queue_waits: Deque[tuple] = collections.deque(maxlen=256)
        self.shed_total = 0
        blocks_per_slot = blocks_for_tokens(cfg.max_len, cfg.kv_block_size)
        self.blocks = KVBlockAllocator(
            cfg.kv_blocks or cfg.max_batch * blocks_per_slot,
            cfg.kv_block_size,
        )
        self.metrics_kv_blocks_live = registry.gauge(
            "kftpu_serving_kv_blocks_live",
            "KV-cache blocks currently held by admitted sequences",
        )
        self.metrics_kv_blocks_total = registry.gauge(
            "kftpu_serving_kv_blocks_total",
            "KV-cache blocks in the pool",
        )
        self.metrics_kv_blocks_total.set(float(self.blocks.total_blocks))
        self.metrics_kv_blocks_shared = registry.gauge(
            "kftpu_serving_kv_blocks_shared",
            "Physical KV blocks referenced by more than one sequence "
            "(copy-on-write prefix sharing)",
        )
        self.metrics_kv_cow_copies = registry.counter(
            "kftpu_serving_kv_cow_copies_total",
            "Copy-on-write forks: a shared KV block copied to a private "
            "page before a sequence's first write into it",
        )
        self.cow_copies = 0
        # Paged state: one scratch-filled table row per slot (the device-
        # visible mirror of the allocator's tables), the prefix-share
        # registry (block-aligned prompt identities -> the live request
        # holding those pages), the shared blocks each admission took, and
        # which pages hold their prompt rows (a prefill writes a shared
        # prefix only while no other prefill has).
        self._max_table_blocks = blocks_per_slot
        self._scratch_block = scratch_block_id(cfg.kv_blocks)
        self._block_tables = np.full((cfg.max_batch, blocks_per_slot),
                                     self._scratch_block, np.int32)
        self._tables_dirty = False
        self._share_registry: Dict[str, int] = {}
        self._rid_share_keys: Dict[int, List[str]] = {}
        self._shared_blocks: Dict[int, int] = {}
        self._page_written = np.zeros(cfg.kv_blocks + 1, bool)
        self.metrics_hbm_occupancy = registry.gauge(
            "kftpu_serving_hbm_pool_occupancy_ratio",
            "Paged KV pool occupancy: blocks live over blocks total",
        )
        self.metrics_hbm_occupancy.set(0.0)
        self.metrics_admissions_midstep = registry.counter(
            "kftpu_serving_admissions_midstep_total",
            "Admissions that claimed a slot while other sequences were "
            "mid-decode (continuous batching in action)",
        )
        self.admissions_midstep = 0
        self._recent_retires: Deque[float] = collections.deque(maxlen=256)
        self._resident_prefixes: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()
        # load()/slot_free_rate() run on HTTP threads and iterate these
        # while the driver thread mutates them.
        self._load_lock = threading.Lock()

        model.to(self.device)
        model.requires_grad_(False)
        if cfg.param_dtype:
            dt = getattr(torch, cfg.param_dtype)
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
        # After the cast, as the JAX engine quantizes the cast tree.
        self.quantized = (_quantize_int8(model, cfg.quantize_min_size)
                          if cfg.quantize else [])
        #: The served weights' bytes (parameters and int8 buffers).
        self.weight_bytes = sum(
            t.numel() * t.element_size()
            for t in itertools.chain(model.parameters(), model.buffers()))
        self._cache = model.init_cache(cfg.max_batch, cfg.max_len,
                                       device=self.device)
        # The one device copy of the tables, read by every decode step (and
        # so by the captured graphs): refreshed in place when the host copy
        # changed (_tables_device).
        self._tables_dev = (torch.tensor(self._block_tables,
                                         device=self.device)
                            if self._paged else None)
        self.tokens_generated = 0
        self.decode_dispatches = 0
        # Grouped prefills and chunked-prefill chunks: one flash launch per
        # layer each on the card.
        self.prefill_dispatches = 0
        self.extend_dispatches = 0

    # ------------- public API -------------

    def submit(self, prompt: List[int], **kw) -> int:
        rid = next(self._req_ids)
        if not prompt:
            raise ValueError("empty prompt")
        limit = self.cfg.max_len - 1
        if len(prompt) > limit:
            raise ValueError(
                f"prompt length {len(prompt)} > limit {limit} "
                f"(max_len {self.cfg.max_len} needs one decode slot)"
            )
        # JAX gathers an out-of-range id into junk; an embedding lookup
        # on a CUDA tensor would hit a device-side assert instead.
        vocab = self.model.cfg.vocab_size
        if any(not 0 <= int(t) < vocab for t in prompt):
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        need = self.blocks.blocks_for_tokens(self._demand_tokens(
            prompt, int(kw.get("max_new_tokens", 32))))
        if need > self.blocks.total_blocks:
            raise ValueError(
                f"request KV demand ({need} blocks) exceeds the pool "
                f"({self.blocks.total_blocks} x "
                f"{self.cfg.kv_block_size}-token blocks) — it could "
                "never admit"
            )
        if self.cfg.max_queue and len(self._queue) >= self.cfg.max_queue:
            self.shed_total += 1
            self.metrics_requests.inc(outcome="shed")
            raise EngineOverloaded(
                f"engine queue full ({len(self._queue)}/"
                f"{self.cfg.max_queue} waiting)",
                retry_after_s=self._drain_estimate_s(),
            )
        self.metrics_requests.inc(outcome="admitted")
        self._queue.append(GenerationRequest(
            prompt=list(prompt), request_id=rid, submitted_at=time.time(), **kw
        ))
        return rid

    def attach_profiler(self, profiler) -> None:
        raise NotImplementedError(
            "the step profiler hook is not ported yet (the tooling slice)")

    # step/run/warmup disable autograd themselves: no_grad is thread-local,
    # and the server drives the engine from its own thread, where a
    # caller's no_grad would not reach (graphs would pile up, and the
    # flash kernel refuses inputs that require grad).
    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit waiting requests into free slots
        (prefill), then decode one chunk for every active slot. Returns
        the number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
        self._drain_decode(self._dispatch_decode(None))
        return len(active)

    @torch.no_grad()
    def run(self) -> List[GenerationResult]:
        """Process until queue and slots drain; returns results in
        completion order, with up to ``pipeline_depth`` decode dispatches
        in flight."""
        order: List[int] = []
        known = set()
        pending: Deque[_InFlight] = collections.deque()
        depth = max(1, self.cfg.pipeline_depth)
        while self._queue or any(s is not None for s in self._slots) \
                or pending:
            # Admission is a pipeline flush point: a fresh dispatch reads
            # host slot state, which lags one chunk per undrained
            # dispatch. Flush only when the queue head can admit now.
            if self._head_admissible():
                while pending:
                    self._drain_decode(pending.popleft())
                self._admit()
            while (
                len(pending) < depth
                and any(s is not None for s in self._slots)
            ):
                pending.append(
                    self._dispatch_decode(pending[-1] if pending else None))
            if pending:
                self._drain_decode(pending.popleft())
            for rid in self._results:
                if rid not in known:
                    known.add(rid)
                    order.append(rid)
        return [self._results[r] for r in order]

    def result(self, rid: int) -> Optional[GenerationResult]:
        return self._results.get(rid)

    def partial(self, rid: int) -> tuple:
        """(tokens so far, logprobs so far, finished) — the streaming
        front end polls this. The driver thread only appends, and the two
        lists may differ by one entry mid-append: callers clamp."""
        res = self._results.get(rid)
        if res is not None:
            return list(res.tokens), list(res.logprobs), True
        for slot in self._slots:
            if slot is not None and slot.req.request_id == rid:
                return list(slot.generated), list(slot.logprobs), False
        return [], [], False

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def _queue_wait_quantile(self, q: float) -> float:
        cutoff = time.monotonic() - LOAD_WINDOW_S
        waits = [w for t, w in self._recent_queue_waits if t >= cutoff]
        return nearest_rank_quantile(waits, q)

    def _head_admissible(self) -> bool:
        if not self._queue or not any(s is None for s in self._slots):
            return False
        head = self._queue[0]
        demand = self._demand_tokens(head.prompt, head.max_new_tokens)
        if not self._paged:
            return self.blocks.can_alloc(demand)
        return self._paged_gate(head.prompt, demand)[0]

    def _demand_tokens(self, prompt: List[int], max_new_tokens: int) -> int:
        """KV positions this request can ever hold: prompt plus requested
        decode length, capped by the cache."""
        return min(len(prompt) + max(1, max_new_tokens), self.cfg.max_len)

    # ------------- physical paging / copy-on-write -------------

    def _share_keys(self, prompt: List[int]) -> List[str]:
        """Block-aligned prefix identities of ``prompt``: one key per whole
        kv_block_size-token prefix (an incremental hash: each key covers
        the full prefix up to its boundary) and an exact full-prompt key,
        as the JAX engine keys them."""
        bs = self.cfg.kv_block_size
        h = hashlib.blake2b(digest_size=16)
        keys: List[str] = []
        done = 0
        for end in range(bs, len(prompt) + 1, bs):
            h.update(np.asarray(prompt[done:end], np.int64).tobytes())
            done = end
            keys.append(f"pb:{end}:{h.hexdigest()}")
        h.update(np.asarray(prompt[done:], np.int64).tobytes())
        keys.append(f"px:{len(prompt)}:{h.hexdigest()}")
        return keys

    def _find_shared_prefix(self, prompt: List[int], n_blocks: int):
        """Longest live prefix match: (shared physical block ids, holder
        rid, tail_shared). An exact full-prompt match shares every block
        the prompt spans, its partial tail block included (tail_shared:
        the first decode write of either party lands there and forks it);
        a block-aligned head match shares only whole blocks below both
        prompts' ends, which decode never writes. Holders are live: the
        registry is scrubbed at retirement."""
        bs = self.cfg.kv_block_size
        keys = self._share_keys(prompt)
        holder = self._share_registry.get(keys[-1])
        if holder is not None:
            t = self.blocks.table(holder)
            if t is not None:
                matched = min(self.blocks.blocks_for_tokens(len(prompt)),
                              len(t), n_blocks)
                return t[:matched], holder, matched * bs > len(prompt)
        for key in reversed(keys[:-1]):
            holder = self._share_registry.get(key)
            t = None if holder is None else self.blocks.table(holder)
            if t is None:
                continue
            matched = min(int(key.split(":", 2)[1]) // bs, len(t), n_blocks)
            if matched > 0:
                return t[:matched], holder, False
        return [], None, False

    @staticmethod
    def _write_position(slot: _Slot) -> int:
        """The cache position the slot's next decode write lands at (its
        cache_index): the prompt and every generated token but the last,
        which is fed back and written by the next step."""
        return len(slot.req.prompt) + max(0, len(slot.generated) - 1)

    def _outstanding_forks(self) -> int:
        """Free blocks to hold back for copy-on-write forks: for every live
        sequence, the shared (refcount > 1) blocks at or past the block of
        its next write. Admission keeps free >= this, so a fork never runs
        out of blocks mid-decode."""
        bs = self.cfg.kv_block_size
        total = 0
        for slot in self._slots:
            t = None if slot is None else self.blocks.table(
                slot.req.request_id)
            if t:
                first = self._write_position(slot) // bs
                total += sum(1 for b in t[first:]
                             if self.blocks.refcount(b) > 1)
        return total

    def _paged_gate(self, prompt: List[int], demand: int):
        """(admissible, shared blocks, tail_shared): the fresh blocks plus
        the fork reservation (two more for a new shared tail: the sharer's
        first write forks it, and the holder's may) fit the free list."""
        n = self.blocks.blocks_for_tokens(demand)
        shared, _, tail_shared = self._find_shared_prefix(prompt, n)
        reserve = self._outstanding_forks() + (2 if tail_shared else 0)
        ok = n - len(shared) + reserve <= self.blocks.blocks_free
        return ok, shared, tail_shared

    def _admit_paged(self, slot_idx: int, req: GenerationRequest,
                     demand: int) -> bool:
        """Claim ``req``'s blocks from the physical pool, its longest live
        prefix match mapped onto the holder's pages (refcounted, no free
        block spent) and the rest fresh. False = the head waits (FIFO)."""
        rid = req.request_id
        ok, shared, _ = self._paged_gate(req.prompt, demand)
        if not ok:
            return False
        try:
            t = self.blocks.alloc(rid, demand, shared=shared)
        except BlocksExhausted:
            return False
        keys = self._share_keys(req.prompt)
        for key in keys:
            self._share_registry[key] = rid
        self._rid_share_keys[rid] = keys
        self._shared_blocks[rid] = len(shared)
        self._page_written[t[len(shared):]] = False
        self._block_tables[slot_idx, :] = self._scratch_block
        self._block_tables[slot_idx, :len(t)] = t
        self._tables_dirty = True
        if shared:
            self.metrics_kv_blocks_shared.set(
                float(self.blocks.blocks_shared))
        return True

    def _prefill_write_from(self, req: GenerationRequest) -> int:
        """The first prompt position ``req``'s prefill writes, and marks
        the pages it writes. The JAX engine lets a sharer's prefill rewrite
        the holder's shared pages with identical values; on the card a k/v
        row computed in a prefill of another shape need not be bitwise the
        same, so while another prefill has already written the shared
        pages, this one skips them (0 otherwise)."""
        t = self.blocks.table(req.request_id)
        shared = t[:self._shared_blocks.pop(req.request_id, 0)]
        start = 0
        if shared and self._page_written[shared].all():
            start = min(len(shared) * self.cfg.kv_block_size,
                        len(req.prompt))
        n = self.blocks.blocks_for_tokens(len(req.prompt))
        self._page_written[t[:n]] = True
        return start

    def _cow_prepare(self, positions: np.ndarray) -> None:
        """Fork every shared block the next decode chunk writes.

        ``positions`` is the dispatch's [B, 1] position array (a chained
        dispatch runs decode_chunk ahead of the host's slot state). A
        slot's writes land at cache positions ``p - 1 .. p + K - 2``
        (positions run one past the cache slot, see the module
        docstring); the JAX engine forks the blocks of ``p .. p + K - 1``
        and so misses a shared block whose last row is ``p - 1`` (an
        identical prompt of block_size x m - 1 tokens). After this pass
        every block the chunk writes has refcount 1, owned by the writer;
        the reservation made at admission guarantees the free blocks."""
        K = max(1, self.cfg.decode_chunk)
        bs = self.cfg.kv_block_size
        forked = False
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            rid = slot.req.request_id
            t = self.blocks.table(rid)
            if not t:
                continue
            w = max(0, int(positions[i, 0]) - 1)
            for bp in range(w // bs, min((w + K - 1) // bs, len(t) - 1) + 1):
                if self.blocks.refcount(t[bp]) <= 1:
                    continue
                pair = self.blocks.write_fork(rid, bp)
                if pair is None:
                    continue
                old, new = pair
                self._copy_cache_block(old, new)
                self._page_written[new] = self._page_written[old]
                self._block_tables[i, bp] = new
                self._tables_dirty = True
                self.cow_copies += 1
                self.metrics_kv_cow_copies.inc()
                forked = True
        if forked:
            self.metrics_kv_blocks_shared.set(
                float(self.blocks.blocks_shared))

    def _copy_cache_block(self, src: int, dst: int) -> None:
        """One copy-on-write device copy: page ``src`` to ``dst`` in every
        layer's pools (K/V and the int8 scale pools), on the stream after
        every step already queued."""
        for layer in self._cache:
            for name in _ROW_LEAVES:
                if name in layer:
                    copy_block(layer[name], src, dst)

    def _tables_device(self) -> torch.Tensor:
        """The device tables, refreshed in place (a copy queued after the
        steps already in flight, which read the old ones) only when the
        host copy changed: admission, retirement, a fork."""
        if self._tables_dirty:
            self._tables_dev.copy_(self._upload(self._block_tables),
                                   non_blocking=True)
            self._tables_dirty = False
        return self._tables_dev

    def slot_free_rate(self) -> float:
        """Recent slot retirements per second (0.0 with fewer than two)."""
        cutoff = time.monotonic() - LOAD_WINDOW_S
        with self._load_lock:
            ts = [t for t in self._recent_retires if t >= cutoff]
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return 0.0
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def _drain_estimate_s(self) -> float:
        rate = self.slot_free_rate()
        if rate > 0:
            return max(1.0, len(self._queue) / rate)
        return self._queue_wait_quantile(0.5) or 1.0

    def _note_resident(self, key: str) -> None:
        """LRU-bump a prefix key into the resident-hint set (bounded)."""
        with self._load_lock:
            self._resident_prefixes.pop(key, None)
            self._resident_prefixes[key] = time.monotonic()
            while len(self._resident_prefixes) > 128:
                self._resident_prefixes.popitem(last=False)

    def load(self) -> dict:
        """Point-in-time load snapshot for /healthz (the LB's load report),
        with the keys of the JAX engine's."""
        active = self.active_slots
        blocks = self.blocks.snapshot()
        with self._load_lock:
            resident = list(self._resident_prefixes)
        return {
            "queued": len(self._queue),
            "active_slots": active,
            "free_slots": self.cfg.max_batch - active,
            "max_batch": self.cfg.max_batch,
            "max_queue": self.cfg.max_queue,
            "shed_total": self.shed_total,
            "p50_queue_wait_s": round(self._queue_wait_quantile(0.5), 6),
            "p95_queue_wait_s": round(self._queue_wait_quantile(0.95), 6),
            "kv_blocks_live": blocks["kv_blocks_live"],
            "kv_blocks_total": blocks["kv_blocks_total"],
            "kv_block_size": blocks["kv_block_size"],
            "kv_paged": self._paged,
            "kv_blocks_shared": blocks["kv_blocks_shared"],
            "kv_table_refs": blocks["kv_table_refs"],
            "kv_cow_copies_total": blocks["kv_cow_copies_total"],
            "kv_blocks_high_water": blocks["kv_blocks_high_water"],
            "hbm_pool_occupancy_ratio": round(
                blocks["kv_blocks_live"]
                / max(1, blocks["kv_blocks_total"]), 6),
            "slot_free_rate": round(self.slot_free_rate(), 4),
            "resident_prefixes": resident,
        }

    @torch.no_grad()
    def warmup(self, prompt_len: int) -> None:
        """Run the decode step and every k-bucket prefill for
        ``prompt_len``'s bucket once with dummy inputs (kernel build and
        load, library handles, allocator pools), and the chunked-prefill
        chunk when ``prompt_len`` exceeds the largest bucket, then reset
        the cache. On the card this captures those prefills' greedy
        graphs, the chunk's greedy graph and the decode chunk's graph of
        every sampling variant: the JAX engine compiles one decode program
        for all of them. A paged engine runs them on scratch-filled tables
        (every junk write lands in the scratch page), as its steps read the
        tables. Only legal while the engine is idle."""
        if self._queue or any(s is not None for s in self._slots):
            raise RuntimeError(
                "warmup() resets the KV cache; call it before submitting "
                "requests, not while generations are active"
            )
        big = self.cfg.prefill_buckets[-1]
        bucket = self._bucket(min(prompt_len, big))
        if prompt_len > big:
            self._run_extend(np.ones((1, big), np.int64), 0, big, 0,
                             np.zeros((1, 3), np.float32))
        ks, k = [], 1
        while k < self.cfg.max_batch:
            ks.append(k)
            k *= 2
        ks.append(self.cfg.max_batch)
        for k in ks:
            self._run_prefill(np.ones((k, bucket), np.int64),
                              np.full((k,), bucket, np.int64),
                              np.zeros((k,), np.int64),
                              np.zeros((k, 3), np.float32),
                              np.full((k, self._max_table_blocks),
                                      self._scratch_block, np.int32),
                              np.zeros((k,), np.int64))
        B = self.cfg.max_batch
        # (temperature, top_k, top_p): greedy, plain, restricted.
        variants = ((0.0, 0.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 1.0))
        for row in variants:
            toks, _ = self._run_decode(
                self._upload(np.zeros((B, 1), np.int64)),
                np.full((B, 1), bucket, np.int64),
                np.tile(np.asarray(row, np.float32), (B, 1)))
        toks.cpu()
        # In place: the captured graphs hold these buffers.
        for layer in self._cache:
            for t in layer.values():
                t.zero_()

    # ------------- internals -------------

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt length {n} exceeds largest prefill bucket "
            f"{self.cfg.prefill_buckets[-1]}"
        )

    def _admit(self) -> None:
        """Admit every request that gets a slot and its KV blocks (FIFO:
        a head that does not fit stops admission), then prefill them one
        dispatch per bucket group."""
        admissions: List[tuple] = []   # (slot_idx, req)
        now = time.time()
        mid_step = any(s is not None for s in self._slots)
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._queue:
                continue
            req = self._queue[0]
            demand = self._demand_tokens(req.prompt, req.max_new_tokens)
            if self._paged:
                if not self._admit_paged(i, req, demand):
                    break
            else:
                try:
                    self.blocks.alloc(req.request_id, demand)
                except BlocksExhausted:
                    break
            self._queue.popleft()
            self._slots[i] = _Slot(req)
            wait = max(0.0, now - req.submitted_at)
            self.metrics_queue_wait.observe(
                wait, exemplar=f"req:{req.request_id}")
            self._recent_queue_waits.append((time.monotonic(), wait))
            self._note_resident(prefix_key(req.prompt))
            for chain_key in prefix_chain(req.prompt):
                self._note_resident(chain_key)
            if req.session:
                self._note_resident(f"s:{req.session}")
            if mid_step:
                self.admissions_midstep += 1
                self.metrics_admissions_midstep.inc()
            admissions.append((i, req))
        if admissions:
            self.metrics_kv_blocks_live.set(float(self.blocks.blocks_live))
            self.metrics_hbm_occupancy.set(
                self.blocks.blocks_live / max(1, self.blocks.total_blocks))
        by_bucket: Dict[int, List[tuple]] = {}
        for i, req in admissions:
            if len(req.prompt) > self.cfg.prefill_buckets[-1]:
                self._prefill_long(i, req)
                continue
            by_bucket.setdefault(self._bucket(len(req.prompt)), []).append(
                (i, req))
        for bucket, group in sorted(by_bucket.items()):
            self._prefill_group(bucket, group)

    def _k_pad(self, n: int) -> int:
        """Group size padded to a power of two, capped at max_batch."""
        k = 1
        while k < n:
            k *= 2
        return min(k, self.cfg.max_batch)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy is
        asynchronous, from pinned memory that PyTorch's host allocator
        does not hand out again before the copy has run, so a dispatch
        never waits for the chunks already queued."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run_step(self, key: tuple, fn, variant: str, **inputs):
        """``fn(**inputs)``: eagerly off the card (or with ``_eager``);
        on the card through the graph captured for ``key``. Its first use
        runs ``fn`` eagerly on the capture stream (the warm-up capture
        needs, and this call's result), then captures it."""
        if not self._graphed:
            return fn(**inputs)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay(**inputs)
        cur, side = torch.cuda.current_stream(self.device), \
            self._capture_stream
        side.wait_stream(cur)
        for t in inputs.values():         # uploaded on cur, read on side
            t.record_stream(side)
        with torch.cuda.stream(side):
            outputs = fn(**inputs)
        cur.wait_stream(side)
        for t in outputs:                 # made on side, read on cur
            t.record_stream(cur)
        self._graphs[key] = self._capture(fn, variant, inputs)
        return outputs

    def _capture(self, fn, variant: str, inputs) -> _Graph:
        """Capture ``fn`` on static copies of ``inputs``. A failed capture
        raises: there is no eager fallback on the card.

        The cyclic garbage collector is off while the capture runs: a pass
        that frees a dropped engine's CUDA graph destroys it in the middle
        of the capture, which invalidates the capture (cuBLAS then fails
        in the next product)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        static = {name: t.clone() for name, t in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        if variant != "greedy":
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this torch cannot register a generator with a CUDA "
                    "graph: a sampled graph would replay the same noise")
            register(self._gen)
        before = _launch_counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=self._capture_stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(**static)
        finally:
            if collecting:
                gc.enable()
        captured = [a - b for a, b in zip(_launch_counts(), before)]
        _add_launches([-d for d in captured])    # nothing ran yet
        return _Graph(graph, static, outputs, captured)

    def _run_prefill(self, tokens: np.ndarray, lengths: np.ndarray,
                     slot_idxs: np.ndarray, samp: np.ndarray,
                     tables: Optional[np.ndarray] = None,
                     write_from: Optional[np.ndarray] = None):
        """One grouped prefill dispatch (graph ``(bucket, k, variant)`` on
        the card); returns device ([k] tokens, [k] logprobs). A paged
        engine also passes the rows' tables and first written positions
        (inputs of the same graph)."""
        k, S = tokens.shape
        variant = sampling_variant(samp)
        self.prefill_dispatches += 1
        inputs = dict(tokens=self._upload(tokens),
                      lengths=self._upload(lengths),
                      slots=self._upload(slot_idxs), samp=self._upload(samp))
        if self._paged:
            inputs.update(tables=self._upload(tables),
                          write_from=self._upload(write_from))

        def fn(tokens, lengths, slots, samp, **paging):
            if self._paged:
                return self._prefill_step_paged(tokens, lengths, slots, samp,
                                                variant, **paging)
            return self._prefill_step(tokens, lengths, slots, samp, variant)

        return self._run_step(("prefill", S, k, variant), fn, variant,
                              **inputs)

    def _prefill_step(self, tok: torch.Tensor, lens: torch.Tensor,
                      slots: torch.Tensor, samp: torch.Tensor, variant: str):
        """Prefill a [k, bucket] padded group against fresh cache rows,
        install them at ``slots`` (a slot that several rows name keeps the
        last one's) and sample each row's first token from its last prompt
        position. Pad tokens past a row's length write junk K/V beyond its
        ``cache_index``, which stays masked until decode overwrites it.
        Device inputs only (it is captured)."""
        dev = self.device
        k, S = tok.shape
        rows = self.model.init_cache(k, S, device=dev)
        positions = torch.arange(S, device=dev).expand(k, S)
        hidden, rows = self.model(tok, positions=positions, cache=rows,
                                  decode="prefill", return_hidden=True)
        # Install: zero the slots' rows, then write the bucket-wide
        # prefix — what the JAX engine's whole-row scatter leaves. The
        # previous occupant's rows past cache_index are masked, but a
        # non-finite one would still poison the product (0 * inf = NaN).
        # k-pad rows repeat row 0 at row 0's slot, and which duplicate
        # write lands is not defined on the card; the last row, k - 1, is
        # the last to name its slot (_prefill_group), so writing it again
        # leaves each slot the rows of its last row, as the reference's
        # scatter leaves it on the CPU (a Llama's copies are identical; a
        # MoE layer's are not).
        width = min(S, self.cfg.max_len)
        for layer, new in zip(self._cache, rows):
            for name in _ROW_LEAVES:
                if name in layer:
                    layer[name].index_fill_(0, slots, 0)
                    layer[name][slots, :width] = new[name][:, :width]
                    layer[name][slots[-1:], :width] = new[name][-1:, :width]
            layer["cache_index"][slots] = lens.to(torch.int32)
        last_h = hidden[torch.arange(k, device=dev), lens - 1][:, None]
        logits = self.model.head_logits(last_h)[:, 0]
        return self._sample_logits(logits.float(), samp, variant)

    def _prefill_step_paged(self, tok: torch.Tensor, lens: torch.Tensor,
                            slots: torch.Tensor, samp: torch.Tensor,
                            variant: str, tables: torch.Tensor,
                            write_from: torch.Tensor):
        """Prefill a [k, bucket] padded group against the pool: the model
        writes each row's k/v through its table ``tables`` [k, max_blocks]
        (pad columns past the row's length, and positions below
        ``write_from``, to the scratch page), so nothing is installed;
        cache_index is set at ``slots``, and each row's first token sampled.
        Device inputs only (it is captured)."""
        dev = self.device
        k, S = tok.shape
        rows = [{**{name: layer[name] for name in _ROW_LEAVES
                    if name in layer},
                 "cache_index": torch.zeros(k, dtype=torch.int32, device=dev)}
                for layer in self._cache]
        positions = torch.arange(S, device=dev).expand(k, S)
        hidden, _ = self.model(tok, positions=positions, cache=rows,
                               decode="prefill", return_hidden=True,
                               paging=Paging(tables, write_lens=lens,
                                             write_from=write_from))
        for layer in self._cache:
            layer["cache_index"][slots] = lens.to(torch.int32)
        last_h = hidden[torch.arange(k, device=dev), lens - 1][:, None]
        logits = self.model.head_logits(last_h)[:, 0]
        return self._sample_logits(logits.float(), samp, variant)

    def _prefill_group(self, bucket: int, group: List[tuple]) -> None:
        k = self._k_pad(len(group))
        tokens = np.zeros((k, bucket), np.int64)
        lengths = np.zeros((k,), np.int64)
        slot_idxs = np.zeros((k,), np.int64)
        samp = np.zeros((k, 3), np.float32)
        write_from = np.zeros((k,), np.int64)
        for row, (i, req) in enumerate(group):
            tokens[row, : len(req.prompt)] = req.prompt
            lengths[row] = len(req.prompt)
            slot_idxs[row] = i
            samp[row] = self._samp_row(req)
            if self._paged:
                write_from[row] = self._prefill_write_from(req)
        # Pad: repeat row 0 and its slot, as the JAX engine does. A MoE
        # layer routes the copies apart from row 0 (capacity goes in row
        # order), so which row's k/v the slot keeps matters: the last
        # row's, k - 1, as the reference's scatter leaves it on the CPU.
        # Dense, _prefill_step writes that row last; paged, it alone
        # writes the slot's pages, and row 0 and the other pads write the
        # scratch page (from position bucket on).
        for row in range(len(group), k):
            tokens[row] = tokens[0]
            lengths[row] = lengths[0]
            slot_idxs[row] = slot_idxs[0]
            samp[row] = samp[0]
        if k > len(group):
            write_from[k - 1] = write_from[0]
            write_from[[0, *range(len(group), k - 1)]] = bucket
        paged = ((self._block_tables[slot_idxs], write_from) if self._paged
                 else ())
        toks, lps = self._run_prefill(tokens, lengths, slot_idxs, samp,
                                      *paged)
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy() if self.cfg.logprobs else None
        for row, (i, req) in enumerate(group):
            self._record_token(
                i, int(toks[row]),
                float(lps[row]) if lps is not None else 0.0)

    def _run_extend(self, tokens: np.ndarray, start: int, true_len: int,
                    slot_idx: int, samp: np.ndarray, write_from: int = 0):
        """One chunk of chunked prefill (graph ``("extend", C, variant)``
        on the card, which serves every slot and start): the host values
        go up as device inputs, as the JAX engine traces them; returns
        device ([1] token, [1] logprob). A paged engine refreshes the
        device tables first, so the step reads the current ones."""
        C = tokens.shape[1]
        variant = sampling_variant(samp)
        self.extend_dispatches += 1

        def scalar(x: int) -> torch.Tensor:
            return self._upload(np.asarray([x], np.int64))

        inputs = dict(tokens=self._upload(tokens), start=scalar(start),
                      true_len=scalar(true_len), slot=scalar(slot_idx),
                      samp=self._upload(samp))
        if self._paged:
            inputs["write_from"] = scalar(write_from)
            self._tables_device()

        def fn(tokens, start, true_len, slot, samp, write_from=None):
            return self._extend_step(tokens, start, true_len, slot, samp,
                                     variant, write_from)

        return self._run_step(("extend", C, variant), fn, variant, **inputs)

    def _extend_step(self, tok: torch.Tensor, start: torch.Tensor,
                     true_len: torch.Tensor, slot: torch.Tensor,
                     samp: torch.Tensor, variant: str,
                     write_from: Optional[torch.Tensor] = None):
        """One chunk of chunked prefill for ONE slot, the JAX engine's
        ``_extend_step``: ``tok`` [1, C] (always a full chunk) runs in
        decode mode at absolute position ``start`` against the slot's
        cache row, taken by the device index ``slot`` (a copy, installed
        back after the forward: the reference's dynamic_slice and
        dynamic_update_slice), its attention through the flash kernel on
        the card; then cache_index[slot] := start + true_len, and position
        true_len - 1 is sampled. A paged engine writes through the slot's
        row of the device tables (positions below ``write_from`` to the
        scratch page), as ``_extend_step_paged`` does. Every input is a
        [1] device tensor (it is captured)."""
        dev = self.device
        C = tok.shape[1]
        index = start.to(torch.int32)      # a copy: the model advances it
        paging = None
        if self._paged:
            paging = Paging(self._tables_dev.index_select(0, slot),
                            write_from=write_from)

        def leaf(layer, name):
            return layer[name] if self._paged \
                else layer[name].index_select(0, slot)

        rows = [{
            **{name: leaf(layer, name) for name in _ROW_LEAVES
               if name in layer},
            "cache_index": index.clone(),
        } for layer in self._cache]
        positions = start[:, None] + torch.arange(C, device=dev)[None, :]
        hidden, _ = self.model(tok, positions=positions, cache=rows,
                               decode=True, return_hidden=True,
                               paging=paging)
        total = (start + true_len).to(torch.int32)
        for layer, row in zip(self._cache, rows):
            if not self._paged:
                for name in _ROW_LEAVES:
                    if name in layer:
                        layer[name].index_copy_(0, slot, row[name])
            layer["cache_index"].index_copy_(0, slot, total)
        last_h = hidden.index_select(1, true_len - 1)          # [1, 1, E]
        logits = self.model.head_logits(last_h)[:, 0]
        return self._sample_logits(logits.float(), samp, variant)

    def _prefill_long(self, slot_idx: int, req: GenerationRequest) -> None:
        """Chunked prefill for a prompt longer than the largest bucket.
        Every chunk is full width; a partial tail SLIDES BACK to end at
        the prompt end, rewriting overlapped positions with identical
        K/V, so no chunk writes past len(prompt)."""
        big = self.cfg.prefill_buckets[-1]
        samp = np.asarray([self._samp_row(req)], np.float32)
        prompt = req.prompt
        starts = list(range(0, len(prompt), big))
        if starts[-1] + big > len(prompt):
            starts[-1] = len(prompt) - big
        write_from = self._prefill_write_from(req) if self._paged else 0
        toks = lps = None
        for off in starts:
            chunk = np.asarray([prompt[off:off + big]], np.int64)
            toks, lps = self._run_extend(chunk, off, big, slot_idx, samp,
                                         write_from)
        self._record_token(
            slot_idx, int(toks.cpu()[0]),
            float(lps.cpu()[0]) if self.cfg.logprobs else 0.0)

    def _gumbel(self, shape) -> torch.Tensor:
        e = torch.empty(shape, device=self.device).exponential_(
            generator=self._gen)
        return -torch.log(e.clamp_min(1e-30))

    def _sample_logits(self, logits: torch.Tensor, samp,
                       variant: Optional[str] = None):
        """On-device sampling of [B, V] f32 logits. ``samp`` holds the
        [B, 3] (temperature, top_k, top_p) rows: a host array, whose
        values choose the branch (:func:`sampling_variant`), or, with
        ``variant`` given, a device tensor (a captured step's input).

        Temperature scales logits, top-k cuts the support, then top-p
        trims it to the smallest prefix holding >= top_p of the mass (the
        first candidate always survives), over the top
        ``sample_candidates`` logits. Rows that asked for no restriction
        keep the full-vocab sample even when a neighbour restricts; rows
        at temperature 0 stay greedy. The noise comes from the engine's
        torch.Generator, so sampled tokens differ from the JAX engine's
        (same distribution, other bits)."""
        if variant is None:
            variant = sampling_variant(samp)
            samp = torch.as_tensor(samp, dtype=torch.float32,
                                   device=logits.device)
        greedy = torch.argmax(logits, dim=-1)
        if variant != "greedy":
            temps, top_ks, top_ps = samp[:, 0], samp[:, 1], samp[:, 2]
            temps_safe = temps.clamp_min(1e-6)[:, None]

            def plain():
                return torch.argmax(
                    logits / temps_safe + self._gumbel(logits.shape), dim=-1)

            if variant == "restricted":
                C = min(int(self.cfg.sample_candidates), logits.shape[-1])
                vals, idx = torch.topk(logits, C, dim=-1)     # [B, C]
                v = vals / temps_safe
                pos = torch.arange(C, device=logits.device)[None, :]
                ks = top_ks.long()
                k_eff = torch.where((ks <= 0) | (ks > C), C, ks)[:, None]
                mask = pos < k_eff
                p = torch.softmax(v.masked_fill(~mask, float("-inf")), -1)
                cum = torch.cumsum(p, dim=-1)
                mask = mask & ((cum - p) < top_ps.clamp_min(1e-6)[:, None])
                ch = torch.argmax(
                    (v + self._gumbel(v.shape)).masked_fill(
                        ~mask, float("-inf")), dim=-1)
                pick = torch.gather(idx, -1, ch[:, None])[:, 0]
                wants = (top_ks > 0) | (top_ps < 1.0)
                sampled = torch.where(wants, pick, plain())
            else:
                sampled = plain()
            tok = torch.where(temps > 0, sampled, greedy)
        else:
            tok = greedy
        if not self.cfg.logprobs:
            return tok, torch.zeros(tok.shape, device=logits.device)
        lf = logits.float()
        logp = torch.gather(lf, -1, tok[:, None])[:, 0] \
            - torch.logsumexp(lf, dim=-1)
        return tok, logp

    @staticmethod
    def _samp_row(req: GenerationRequest) -> tuple:
        return (req.temperature, float(req.top_k), req.top_p)

    def _run_decode(self, tokens: torch.Tensor, positions: np.ndarray,
                    samp: np.ndarray):
        """One decode chunk (graph ``variant`` on the card): [B, 1] device
        tokens in, ([B, K] tokens, [B, K] logprobs) out."""
        variant = sampling_variant(samp)

        def fn(tokens, positions, samp):
            return self._decode_step(tokens, positions, samp, variant)

        return self._run_step(
            ("decode", variant), fn, variant, tokens=tokens,
            positions=self._upload(positions), samp=self._upload(samp))

    def _decode_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                     samp: torch.Tensor, variant: str):
        """Decode ``decode_chunk`` tokens for every slot: each step feeds
        the previous step's device tokens back, with no host round trip
        inside the chunk; a staging model writes step i's k/v at staging
        column i, and the chunk ends with one flush. Device inputs only
        (it is captured). Returns ([B, K] tokens, [B, K] logprobs)."""
        outs, lps = [], []
        paging = Paging(self._tables_dev) if self._paged else None
        for i in range(self.cfg.decode_chunk):
            logits, _ = self.model(
                tokens, positions=pos, cache=self._cache, decode=True,
                stage_step=i if self._staging else None, paging=paging)
            nxt, lp = self._sample_logits(logits[:, 0], samp, variant)
            outs.append(nxt)
            lps.append(lp)
            tokens, pos = nxt[:, None], pos + 1
        if self._staging:
            self._flush_staging(self.cfg.decode_chunk)
        return torch.stack(outs, dim=1), torch.stack(lps, dim=1)

    def _flush_staging(self, steps: int) -> None:
        """Write each layer's staging rows [:, :steps] into its cache at
        every slot's ``cache_index`` (quantized there for an int8 cache),
        then advance ``cache_index``: the JAX engine's
        ``_flush_staging``. The write start clamps at ``max_len - steps``
        as dynamic_update_slice clamps it (idle slots' indices grow
        without bound); the index itself does not clamp. A paged engine
        writes at the pool rows the tables map the positions to (past a
        table, and idle slots' scratch-filled rows, to the scratch page)."""
        dev = self.device
        B = self.cfg.max_batch
        batch = torch.arange(B, device=dev)[:, None]
        cols = torch.arange(steps, device=dev)[None, :]
        for layer in self._cache:
            idx = layer["cache_index"]
            if self._paged:
                self._flush_paged(layer, idx.long()[:, None] + cols, steps)
                continue
            L = layer["cached_key"].shape[1]
            rows = idx.long().clamp(0, max(L - steps, 0))[:, None] + cols
            sk = layer["stage_key"][:, :steps]
            sv = layer["stage_value"][:, :steps]
            if "key_scale" in layer:
                k8, ks = quantize_kv_rows(sk)
                v8, vs = quantize_kv_rows(sv)
                layer["cached_key"][batch, rows] = k8
                layer["key_scale"][batch, rows] = ks
                layer["cached_value"][batch, rows] = v8
                layer["value_scale"][batch, rows] = vs
            else:
                layer["cached_key"][batch, rows] = sk
                layer["cached_value"][batch, rows] = sv
            idx.add_(steps)

    def _flush_paged(self, layer, positions: torch.Tensor,
                     steps: int) -> None:
        rows = physical_rows(self._tables_dev, positions,
                             self.cfg.kv_block_size,
                             num_blocks=self.cfg.kv_blocks)
        sk = layer["stage_key"][:, :steps]
        sv = layer["stage_value"][:, :steps]
        if "key_scale" in layer:
            k8, ks = quantize_kv_rows(sk)
            v8, vs = quantize_kv_rows(sv)
            scatter_kv_rows(layer["cached_key"], rows, k8)
            scatter_kv_rows(layer["key_scale"], rows, ks)
            scatter_kv_rows(layer["cached_value"], rows, v8)
            scatter_kv_rows(layer["value_scale"], rows, vs)
        else:
            scatter_kv_rows(layer["cached_key"], rows, sk)
            scatter_kv_rows(layer["cached_value"], rows, sv)
        layer["cache_index"].add_(steps)

    def _dispatch_decode(self, chain: Optional[_InFlight] = None
                         ) -> _InFlight:
        """Queue one decode chunk on the device without fetching its
        results. With ``chain`` (the previous undrained dispatch), the
        input tokens are its device-resident last tokens and positions
        advance by its chunk length. Idle slots decode too (junk rows
        whose writes clamp at the cache end)."""
        B = self.cfg.max_batch
        positions = np.zeros((B, 1), np.int64)
        samp = np.zeros((B, 3), np.float32)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                samp[i] = self._samp_row(slot.req)
        if chain is not None:
            tokens = chain.out[:, -1:]
            positions = chain.positions + self.cfg.decode_chunk
        else:
            host = np.zeros((B, 1), np.int64)
            for i, slot in enumerate(self._slots):
                if slot is None:
                    continue
                host[i, 0] = (slot.generated or slot.req.prompt)[-1]
                positions[i, 0] = slot.pos
            tokens = self._upload(host)
        if self._paged:
            # Forks first (they change tables and pages), then the device
            # tables the step reads.
            self._cow_prepare(positions)
            self._tables_device()
        toks, lps = self._run_decode(tokens, positions, samp)
        self.decode_dispatches += 1
        return _InFlight(out=toks, lps=lps, positions=positions,
                         snapshot=list(self._slots))

    def _drain_decode(self, inflight: _InFlight) -> None:
        toks = inflight.out.cpu().numpy()          # [B, K] (waits here)
        lps = inflight.lps.cpu().numpy() if self.cfg.logprobs else None
        for k in range(toks.shape[1]):
            for i, slot in enumerate(self._slots):
                # Only slots active at dispatch AND still holding the same
                # request: a slot freed mid-pipeline must not receive
                # another request's speculative tail.
                if slot is None or slot is not inflight.snapshot[i]:
                    continue
                self._record_token(
                    i, int(toks[i, k]),
                    float(lps[i, k]) if lps is not None else 0.0)

    def _record_token(self, slot_idx: int, token: int,
                      logprob: float = 0.0) -> None:
        slot = self._slots[slot_idx]
        if slot is None:
            raise RuntimeError(f"token recorded for empty slot {slot_idx}")
        if slot.first_token_at is None:
            slot.first_token_at = time.time()
        slot.generated.append(token)
        slot.logprobs.append(logprob)
        slot.pos += 1
        self.tokens_generated += 1
        req = slot.req
        done_eos = req.eos_token is not None and token == req.eos_token
        done_len = len(slot.generated) >= req.max_new_tokens
        done_cap = slot.pos >= self.cfg.max_len - 1
        if not (done_eos or done_len or done_cap):
            return
        now = time.time()
        ttft = slot.first_token_at - req.submitted_at
        self.metrics_ttft.observe(max(0.0, ttft),
                                  exemplar=f"req:{req.request_id}")
        if len(slot.generated) > 1:
            self.metrics_per_token.observe(
                max(0.0, now - slot.first_token_at)
                / (len(slot.generated) - 1))
        self._results[req.request_id] = GenerationResult(
            request_id=req.request_id,
            tokens=list(slot.generated),
            prompt_len=len(req.prompt),
            finished_reason="eos" if done_eos else "length",
            latency_s=now - req.submitted_at,
            ttft_s=ttft,
            logprobs=list(slot.logprobs),
        )
        # Mid-step retirement: the slot and its blocks free now, so the
        # next _admit refills from the queue.
        self._slots[slot_idx] = None
        self.blocks.free(req.request_id)
        if self._paged:
            # Steps still in flight carry the old device tables: their
            # writes land in freed pages, which no one takes before the
            # next admission (a pipeline flush point).
            self._block_tables[slot_idx, :] = self._scratch_block
            self._tables_dirty = True
            self._shared_blocks.pop(req.request_id, None)
            for key in self._rid_share_keys.pop(req.request_id, []):
                if self._share_registry.get(key) == req.request_id:
                    self._share_registry.pop(key)
            self.metrics_kv_blocks_shared.set(
                float(self.blocks.blocks_shared))
        with self._load_lock:
            self._recent_retires.append(time.monotonic())
        self.metrics_kv_blocks_live.set(float(self.blocks.blocks_live))
        self.metrics_hbm_occupancy.set(
            self.blocks.blocks_live / max(1, self.blocks.total_blocks))

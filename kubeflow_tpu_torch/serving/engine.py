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

Positions follow the JAX engine exactly, including its decode RoPE
positions, which run one past the cache slot they are written to
(``_Slot.pos`` counts the prefill's first token before it is fed back):
greedy tokens match the JAX engine's, and a full re-forward reproduces
them only with the same positions.

Out of scope in this slice (each raises NotImplementedError): the
physically paged cache with copy-on-write, staged decode, int8 weights,
mesh serving and the step profiler.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import Llama
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
    # Weight-only int8 quantization: a later slice (raises if set).
    quantize: str = ""
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


class ServingEngine:
    """Serves ``model`` (its own parameters) on ``device`` — ``cuda``
    unless the caller asks for ``"cpu"``. The engine casts the model's
    floating parameters to ``cfg.param_dtype`` IN PLACE (a copy would
    double the weights' device memory) and turns their gradients off."""

    def __init__(
        self,
        model: Llama,
        cfg: ServingConfig,
        *,
        device: DeviceLike = None,
        registry: MetricsRegistry = global_registry,
        mesh=None,
        profiler=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (the multi-GPU slice)")
        if profiler is not None:
            raise NotImplementedError(
                "the step profiler hook is not ported yet (the tooling "
                "slice)")
        if cfg.quantize:
            raise NotImplementedError(
                f"quantize={cfg.quantize!r}: int8 weights are not ported "
                "yet (the int8 serving slice)")
        if model.cfg.max_seq_len < cfg.max_len:
            raise ValueError(
                f"model max_seq_len {model.cfg.max_seq_len} < engine max_len "
                f"{cfg.max_len}"
            )
        if cfg.decode_chunk < 1:
            raise ValueError(f"decode_chunk {cfg.decode_chunk} must be >= 1")
        self.device = resolve_device(device)
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
        self._cache = model.init_cache(cfg.max_batch, cfg.max_len,
                                       device=self.device)
        self.tokens_generated = 0
        self.decode_dispatches = 0
        # Grouped prefills (one flash launch per layer each); chunked
        # prefill chunks run the decode attention and are not counted.
        self.prefill_dispatches = 0

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
        return self.blocks.can_alloc(
            self._demand_tokens(head.prompt, head.max_new_tokens))

    def _demand_tokens(self, prompt: List[int], max_new_tokens: int) -> int:
        """KV positions this request can ever hold: prompt plus requested
        decode length, capped by the cache."""
        return min(len(prompt) + max(1, max_new_tokens), self.cfg.max_len)

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
            "kv_paged": False,
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
        load, library handles, allocator pools), then reset the cache.
        Only legal while the engine is idle."""
        if self._queue or any(s is not None for s in self._slots):
            raise RuntimeError(
                "warmup() resets the KV cache; call it before submitting "
                "requests, not while generations are active"
            )
        big = self.cfg.prefill_buckets[-1]
        bucket = self._bucket(min(prompt_len, big))
        if prompt_len > big:
            self._extend_step(np.ones((1, big), np.int64), 0, big, 0,
                              np.zeros((1, 3), np.float32))
        ks, k = [], 1
        while k < self.cfg.max_batch:
            ks.append(k)
            k *= 2
        ks.append(self.cfg.max_batch)
        for k in ks:
            self._prefill_step(np.ones((k, bucket), np.int64),
                               np.full((k,), bucket, np.int64),
                               np.zeros((k,), np.int64),
                               np.zeros((k, 3), np.float32))
        B = self.cfg.max_batch
        toks, _ = self._decode_step(
            torch.zeros((B, 1), dtype=torch.long, device=self.device),
            np.full((B, 1), bucket, np.int64), np.zeros((B, 3), np.float32))
        toks.cpu()
        self._cache = self.model.init_cache(self.cfg.max_batch,
                                            self.cfg.max_len,
                                            device=self.device)

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
            try:
                self.blocks.alloc(req.request_id, self._demand_tokens(
                    req.prompt, req.max_new_tokens))
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

    def _prefill_step(self, tokens: np.ndarray, lengths: np.ndarray,
                      slot_idxs: np.ndarray, samp: np.ndarray):
        """Prefill a [k, bucket] padded group against fresh cache rows,
        install the rows at ``slot_idxs`` and sample each row's first
        token from its last prompt position. Pad tokens past a row's
        length write junk K/V beyond its ``cache_index``, which stays
        masked until decode overwrites it."""
        dev = self.device
        k, S = tokens.shape
        self.prefill_dispatches += 1
        tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        lens = torch.as_tensor(lengths, dtype=torch.long, device=dev)
        slots = torch.as_tensor(slot_idxs, dtype=torch.long, device=dev)
        rows = self.model.init_cache(k, S, device=dev)
        positions = torch.arange(S, device=dev).expand(k, S)
        hidden, rows = self.model(tok, positions=positions, cache=rows,
                                  decode="prefill", return_hidden=True)
        # Install: zero the slots' rows, then write the bucket-wide
        # prefix — what the JAX engine's whole-row scatter leaves. The
        # previous occupant's rows past cache_index are masked, but a
        # non-finite one would still poison the product (0 * inf = NaN).
        # k-pad rows repeat row 0 at row 0's slot: duplicate indices
        # write IDENTICAL rows (same tokens, same positions), so whichever
        # write lands last leaves the same cache.
        width = min(S, self.cfg.max_len)
        for layer, new in zip(self._cache, rows):
            for name in ("cached_key", "cached_value"):
                layer[name].index_fill_(0, slots, 0)
                layer[name][slots, :width] = new[name][:, :width]
            layer["cache_index"][slots] = lens.to(torch.int32)
        last_h = hidden[torch.arange(k, device=dev), lens - 1][:, None]
        logits = self.model.head_logits(last_h)[:, 0]
        return self._sample_logits(logits.float(), samp)

    def _prefill_group(self, bucket: int, group: List[tuple]) -> None:
        k = self._k_pad(len(group))
        tokens = np.zeros((k, bucket), np.int64)
        lengths = np.zeros((k,), np.int64)
        slot_idxs = np.zeros((k,), np.int64)
        samp = np.zeros((k, 3), np.float32)
        for row, (i, req) in enumerate(group):
            tokens[row, : len(req.prompt)] = req.prompt
            lengths[row] = len(req.prompt)
            slot_idxs[row] = i
            samp[row] = self._samp_row(req)
        for row in range(len(group), k):          # pad: repeat row 0
            tokens[row] = tokens[0]
            lengths[row] = lengths[0]
            slot_idxs[row] = slot_idxs[0]
            samp[row] = samp[0]
        toks, lps = self._prefill_step(tokens, lengths, slot_idxs, samp)
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy() if self.cfg.logprobs else None
        for row, (i, req) in enumerate(group):
            self._record_token(
                i, int(toks[row]),
                float(lps[row]) if lps is not None else 0.0)

    def _extend_step(self, tokens: np.ndarray, start: int, true_len: int,
                     slot_idx: int, samp: np.ndarray):
        """One chunk of chunked prefill for ONE slot: ``tokens`` [1, C]
        (always a full chunk) run in decode mode against the slot's live
        cache row at absolute position ``start`` — the model writes
        through a view into the batch cache — then cache_index :=
        start + true_len, and position true_len - 1 is sampled."""
        dev = self.device
        C = tokens.shape[1]
        rows = [{
            "cached_key": layer["cached_key"][slot_idx:slot_idx + 1],
            "cached_value": layer["cached_value"][slot_idx:slot_idx + 1],
            "cache_index": torch.full((1,), start, dtype=torch.int32,
                                      device=dev),
        } for layer in self._cache]
        positions = start + torch.arange(C, device=dev)[None, :]
        hidden, _ = self.model(
            torch.as_tensor(tokens, dtype=torch.long, device=dev),
            positions=positions, cache=rows, decode=True, return_hidden=True)
        for layer in self._cache:
            layer["cache_index"][slot_idx] = start + true_len
        logits = self.model.head_logits(
            hidden[:, true_len - 1:true_len])[:, 0]
        return self._sample_logits(logits.float(), samp)

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
        toks = lps = None
        for off in starts:
            chunk = np.asarray([prompt[off:off + big]], np.int64)
            toks, lps = self._extend_step(chunk, off, big, slot_idx, samp)
        self._record_token(
            slot_idx, int(toks.cpu()[0]),
            float(lps.cpu()[0]) if self.cfg.logprobs else 0.0)

    def _gumbel(self, shape) -> torch.Tensor:
        e = torch.empty(shape, device=self.device).exponential_(
            generator=self._gen)
        return -torch.log(e.clamp_min(1e-30))

    def _sample_logits(self, logits: torch.Tensor, samp: np.ndarray):
        """On-device sampling of [B, V] f32 logits. ``samp`` is the host
        [B, 3] array of (temperature, top_k, top_p) rows, so the branches
        the JAX step takes with lax.cond are chosen here on the host.

        Temperature scales logits, top-k cuts the support, then top-p
        trims it to the smallest prefix holding >= top_p of the mass (the
        first candidate always survives), over the top
        ``sample_candidates`` logits. Rows that asked for no restriction
        keep the full-vocab sample even when a neighbour restricts; rows
        at temperature 0 stay greedy. The noise comes from the engine's
        torch.Generator, so sampled tokens differ from the JAX engine's
        (same distribution, other bits)."""
        greedy = torch.argmax(logits, dim=-1)
        temps_h, ks_h, ps_h = samp[:, 0], samp[:, 1], samp[:, 2]
        if np.any(temps_h > 0):
            t = torch.as_tensor(samp, dtype=torch.float32,
                                device=logits.device)
            temps, top_ks, top_ps = t[:, 0], t[:, 1], t[:, 2]
            temps_safe = temps.clamp_min(1e-6)[:, None]

            def plain():
                return torch.argmax(
                    logits / temps_safe + self._gumbel(logits.shape), dim=-1)

            if np.any((temps_h > 0) & ((ks_h > 0) | (ps_h < 1.0))):
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

    def _decode_step(self, tokens: torch.Tensor, positions: np.ndarray,
                     samp: np.ndarray):
        """Decode ``decode_chunk`` tokens for every slot: each step feeds
        the previous step's device tokens back, with no host round trip
        inside the chunk. Returns ([B, K] tokens, [B, K] logprobs)."""
        pos = torch.as_tensor(positions, dtype=torch.long,
                              device=self.device)
        outs, lps = [], []
        for _ in range(self.cfg.decode_chunk):
            logits, self._cache = self.model(
                tokens, positions=pos, cache=self._cache, decode=True)
            nxt, lp = self._sample_logits(logits[:, 0], samp)
            outs.append(nxt)
            lps.append(lp)
            tokens, pos = nxt[:, None], pos + 1
        return torch.stack(outs, dim=1), torch.stack(lps, dim=1)

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
            tokens = torch.as_tensor(host, device=self.device)
        toks, lps = self._decode_step(tokens, positions, samp)
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
        with self._load_lock:
            self._recent_retires.append(time.monotonic())
        self.metrics_kv_blocks_live.set(float(self.blocks.blocks_live))
        self.metrics_hbm_occupancy.set(
            self.blocks.blocks_live / max(1, self.blocks.total_blocks))

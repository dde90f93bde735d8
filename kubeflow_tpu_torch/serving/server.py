"""Serving HTTP front end of the port: the engine as a queryable workload.

  POST /v1/generate   {"tokens": [...], "max_new_tokens": N,
                       "temperature": t, "top_k": k, "top_p": p,
                       "eos_token": id}
                      -> {"tokens": [...], "ttft_s": ..., "latency_s": ...,
                          "logprobs": [...] when the engine enables them}
                      with "stream": true -> NDJSON chunks: {"tokens":
                      [delta...]}* then {"done": true, ...metadata}
  GET  /v1/models     -> model + engine config
  GET  /healthz       -> readiness probe and load report

One driver thread owns the engine; HTTP handlers enqueue requests and wait
on per-request events, so concurrent clients batch into the same decode
step. ``python -m kubeflow_tpu_torch.serving.server`` reads the
``KFTPU_SERVING_*`` env contract of the JAX server.
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import torch

from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.engine import (
    EngineOverloaded,
    ServingConfig,
    ServingEngine,
)
from kubeflow_tpu_torch.utils.device import platform_device
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.router import (
    JsonHttpServer,
    NdjsonStream,
    Request,
    RestError,
    Router,
)

log = get_logger("serving")


class ServingServer:
    """HTTP app + engine driver thread. ``start()`` returns once the socket
    is listening (readiness == queryable)."""

    def __init__(
        self,
        engine: ServingEngine,
        *,
        model_name: str = "",
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 120.0,
    ):
        self.engine = engine
        self.model_name = model_name
        self.request_timeout_s = request_timeout_s
        self.error = ""                  # set when the engine loop degrades
        self._submissions: "queue.Queue[tuple]" = queue.Queue()
        self._events: Dict[int, threading.Event] = {}
        self._stop = threading.Event()
        self._driver: Optional[threading.Thread] = None

        router = Router()
        router.post("/v1/generate", self._generate)
        router.get("/v1/models", self._models)
        router.get("/healthz", self._healthz)
        self._http = JsonHttpServer(router, host=host, port=port)
        self.port = self._http.port

    # ------------- lifecycle -------------

    def start(self) -> "ServingServer":
        self._driver = threading.Thread(target=self._drive, daemon=True)
        self._driver.start()
        self._http.start()
        log.info("serving up", kv={"port": self.port,
                                   "model": self.model_name or "?"})
        return self

    def stop(self) -> None:
        self._stop.set()
        self._http.stop()
        if self._driver:
            self._driver.join(timeout=10)

    # ------------- engine driver (single thread owns the engine) -------------

    def _drive(self) -> None:
        while not self._stop.is_set():
            moved = False
            try:
                while True:
                    prompt, kw, holder, ev = self._submissions.get_nowait()
                    try:
                        rid = self.engine.submit(prompt, **kw)
                        holder["rid"] = rid
                        self._events[rid] = ev
                    except EngineOverloaded as e:
                        # Bounded admission: overload is NOT a client
                        # error — surface 429 + Retry-After so clients
                        # back off for one queue-drain instead of
                        # hammering a full queue.
                        holder["overloaded"] = str(e)
                        holder["retry_after_s"] = e.retry_after_s
                        ev.set()
                    except ValueError as e:
                        holder["error"] = str(e)
                        ev.set()
                    finally:
                        sub_ev = holder.get("submitted")
                        if sub_ev is not None:
                            sub_ev.set()
                    moved = True
            except queue.Empty:
                pass
            try:
                if self.engine.step() > 0:
                    moved = True
            except Exception as e:  # noqa: BLE001 — driver must survive
                # An engine failure must not silently kill the driver (every
                # request would then 504 while /healthz stays green). Mark
                # degraded, fail all waiters, keep draining submissions.
                self.error = f"engine step failed: {e!r}"
                log.error("engine step failed", kv={"err": repr(e)})
                for rid in list(self._events):
                    self._events.pop(rid).set()
            for rid in [r for r in self._events]:
                res = self.engine.result(rid)
                if res is not None:
                    self._events.pop(rid).set()
            if not moved:
                time.sleep(0.002)

    # ------------- handlers -------------

    def _generate(self, req: Request) -> Any:
        tokens = req.body.get("tokens")
        if tokens is None and "text" in req.body:
            raise RestError(400, "body.text needs a server-side tokenizer, "
                                 "which this server does not load yet; "
                                 "send body.tokens")
        if not isinstance(tokens, list) or not all(
            isinstance(t, int) for t in tokens
        ):
            raise RestError(400, "body.tokens must be a list of ints")
        kw: Dict[str, Any] = {}
        if "max_new_tokens" in req.body:
            kw["max_new_tokens"] = int(req.body["max_new_tokens"])
        if "temperature" in req.body:
            kw["temperature"] = float(req.body["temperature"])
        if "top_k" in req.body:
            kw["top_k"] = int(req.body["top_k"])
        if "top_p" in req.body:
            kw["top_p"] = float(req.body["top_p"])
        if "eos_token" in req.body:
            kw["eos_token"] = int(req.body["eos_token"])
        if isinstance(req.body.get("session"), str) and req.body["session"]:
            # Cache-affinity session key: recorded into the engine's
            # resident-prefix hints so load reports advertise the
            # session's residency back to the LB.
            kw["session"] = req.body["session"]
        stream = bool(req.body.get("stream", False))
        holder: Dict[str, Any] = {}
        ev = threading.Event()
        if stream:
            # Wait for the driver to actually submit before committing a
            # 200: validation failures (oversized prompt) must surface as
            # the same 400 the non-stream path returns, not as an error
            # chunk inside a successful stream.
            holder["submitted"] = threading.Event()
            self._submissions.put((tokens, kw, holder, ev))
            if not holder["submitted"].wait(self.request_timeout_s):
                raise RestError(504, "generation timed out")
            self._raise_if_overloaded(holder)
            if "error" in holder:
                raise RestError(400, holder["error"])
            return NdjsonStream(self._stream_chunks(holder["rid"], ev))
        self._submissions.put((tokens, kw, holder, ev))
        if not ev.wait(self.request_timeout_s):
            raise RestError(504, "generation timed out")
        self._raise_if_overloaded(holder)
        if "error" in holder:
            raise RestError(400, holder["error"])
        res = self.engine.result(holder["rid"])
        if res is None:
            raise RestError(500, self.error or "generation failed")
        out = {
            "tokens": res.tokens,
            "prompt_len": res.prompt_len,
            "finished_reason": res.finished_reason,
            "ttft_s": res.ttft_s,
            "latency_s": res.latency_s,
        }
        if self.engine.cfg.logprobs:
            out["logprobs"] = res.logprobs
        return out

    @staticmethod
    def _raise_if_overloaded(holder: Dict[str, Any]) -> None:
        """EngineOverloaded → HTTP 429 with Retry-After (integer seconds,
        >= 1): the engine's own queue-drain estimate, so shed clients back
        off for one recovery window instead of retrying into the same
        full queue."""
        if "overloaded" not in holder:
            return
        retry = max(1, int(math.ceil(holder.get("retry_after_s", 1.0))))
        raise RestError(429, holder["overloaded"],
                        headers={"Retry-After": str(retry)})

    def _stream_chunks(self, rid: int, ev: threading.Event):
        """NDJSON token streaming: emits {"tokens": [...]} deltas as the
        engine decodes (granularity = decode_chunk), then one final chunk
        with the completion metadata. Mid-stream failures (engine death,
        timeout) arrive as an {"error": ...} chunk — the 200 and headers
        are already on the wire by then. ``ev`` fires on completion, so
        the poll sleep doubles as the completion wait."""
        deadline = time.time() + self.request_timeout_s
        sent = 0
        while True:
            toks, lps, finished = self.engine.partial(rid)
            # lps parallels toks but is appended after it by the driver
            # thread; clamp the delta to the shorter list and let the
            # next poll carry the remainder. Never skip the
            # deadline/error checks below — a stalled driver must still
            # time the stream out.
            n = min(len(toks), len(lps))
            if n > sent:
                chunk = {"tokens": toks[sent:n]}
                if self.engine.cfg.logprobs:
                    chunk["logprobs"] = lps[sent:n]
                yield chunk
                sent = n
            if finished:
                break
            if time.time() > deadline:
                yield {"error": "generation timed out"}
                return
            if self.error:
                yield {"error": self.error}
                return
            ev.wait(0.005)
        res = self.engine.result(rid)
        done = {
            "done": True,
            "prompt_len": res.prompt_len,
            "finished_reason": res.finished_reason,
            "ttft_s": res.ttft_s,
            "latency_s": res.latency_s,
        }
        yield done

    def _models(self, req: Request) -> Any:
        cfg = self.engine.model.cfg
        return {
            "models": [{
                "name": self.model_name or type(self.engine.model).__name__,
                "vocab_size": cfg.vocab_size,
                "max_len": self.engine.cfg.max_len,
                "max_batch": self.engine.cfg.max_batch,
            }]
        }

    def _healthz(self, req: Request) -> Any:
        payload = {
            "ok": not self.error,
            "active": self.engine.active_slots,
            "queued": self.engine.queued,
            "tokens_generated": self.engine.tokens_generated,
            # Load snapshot: the LB's health checks double as load
            # reports (queue-depth-aware dispatch + shedding) and the
            # ServingAutoscaler scrapes the queue-wait percentiles.
            "load": self.engine.load(),
        }
        if self.error:
            payload["error"] = self.error
            return 503, payload
        return payload


# ---------------------------------------------------------------- entrypoint


def env_config() -> dict:
    """KFTPU_SERVING_* env contract of the JAX server."""
    mesh = json.loads(os.environ.get("KFTPU_SERVING_MESH", "{}") or "{}")
    return {
        "model": os.environ.get("KFTPU_SERVING_MODEL", "llama-tiny"),
        "mesh": mesh,
        "port": int(os.environ.get("KFTPU_SERVING_PORT", "8000")),
        "host": os.environ.get("KFTPU_SERVING_HOST", "0.0.0.0"),
        "max_batch": int(os.environ.get("KFTPU_SERVING_MAX_BATCH", "8")),
        "max_len": int(os.environ.get("KFTPU_SERVING_MAX_LEN", "1024")),
        "max_queue": int(os.environ.get("KFTPU_SERVING_MAX_QUEUE", "0")),
        "kv_block_size": int(
            os.environ.get("KFTPU_SERVING_KV_BLOCK_SIZE", "0")),
        "kv_blocks": int(os.environ.get("KFTPU_SERVING_KV_BLOCKS", "0")),
        "decode_chunk": int(
            os.environ.get("KFTPU_SERVING_DECODE_CHUNK", "8")),
        "quantize": os.environ.get("KFTPU_SERVING_QUANTIZE", ""),
        "quantize_kv": os.environ.get("KFTPU_SERVING_QUANTIZE_KV", ""),
        "param_dtype": os.environ.get("KFTPU_SERVING_PARAM_DTYPE", ""),
        "prefill_buckets": [
            int(b)
            for b in os.environ.get(
                "KFTPU_SERVING_PREFILL_BUCKETS", "").split(",")
            if b.strip()
        ],
        "pipeline_depth": int(
            os.environ.get("KFTPU_SERVING_PIPELINE_DEPTH", "0")),
        "logprobs": os.environ.get(
            "KFTPU_SERVING_LOGPROBS", "") not in ("", "0", "false"),
        "checkpoint_dir": os.environ.get(
            "KFTPU_SERVING_CHECKPOINT_DIR", ""),
        "tokenizer": os.environ.get("KFTPU_SERVING_TOKENIZER", ""),
    }


#: Env options of the JAX server that later slices of the port take up.
_LATER_SLICES = (
    ("quantize", "KFTPU_SERVING_QUANTIZE", "int8 serving"),
    ("quantize_kv", "KFTPU_SERVING_QUANTIZE_KV", "int8 serving"),
    ("mesh", "KFTPU_SERVING_MESH", "multi-GPU"),
    ("checkpoint_dir", "KFTPU_SERVING_CHECKPOINT_DIR", "checkpoint"),
    ("tokenizer", "KFTPU_SERVING_TOKENIZER", "tooling"),
)


def build_server(cfg: dict) -> ServingServer:
    """Model, weights and engine on the device ``KFTPU_PLATFORM`` selects
    (``cpu``, else ``cuda``, which raises without a card).

    The weights are random, made on the device directly in the serving
    dtype from a seeded generator (an f32 host init of an 8B model would
    take 32 GB and minutes): N(0, 0.02) for projections and embeddings,
    ones for norms. Decode staging, which the JAX server turns on, is a
    scheduling optimisation with the same output and a later slice; this
    server decodes unstaged."""
    for key, env, slice_ in _LATER_SLICES:
        if cfg.get(key):
            raise NotImplementedError(
                f"{env}={cfg[key]!r} is not supported by the PyTorch port "
                f"yet (the {slice_} slice)")
    device = platform_device()
    param_dtype = cfg.get("param_dtype") or "bfloat16"
    with torch.device(device):
        model, _ = get_model(cfg["model"], param_dtype=param_dtype)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    log.info("serving model build", kv={"model": cfg["model"],
                                        "device": str(device),
                                        "param_dtype": param_dtype})
    scfg_kw = dict(max_batch=cfg["max_batch"], max_len=cfg["max_len"],
                   decode_chunk=cfg["decode_chunk"])
    for key in ("max_queue", "kv_block_size", "kv_blocks", "param_dtype",
                "pipeline_depth"):
        if cfg.get(key):
            scfg_kw[key] = cfg[key]
    if cfg.get("prefill_buckets"):
        scfg_kw["prefill_buckets"] = tuple(cfg["prefill_buckets"])
    if cfg.get("logprobs"):
        scfg_kw["logprobs"] = True
    engine = ServingEngine(model, ServingConfig(**scfg_kw), device=device)
    return ServingServer(engine, model_name=cfg["model"], host=cfg["host"],
                         port=cfg["port"])


def main() -> int:
    server = build_server(env_config()).start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

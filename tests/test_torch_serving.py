"""The port's ServingEngine and ServingServer against the JAX package's.

Both engines serve llama-tiny with the SAME weights (JAX init, converted
with llama_params_from_jax) in f32 (``param_dtype=""``), projections
scaled x8 so that attention is sharp (positions then matter) and greedy
choices sit far apart. Greedy tokens must be identical; logprobs agree to
atol 1e-4. Sampling draws different noise in the two frameworks, so the
sampler is checked for support, not for tokens. Staged decode
(``decode_staging``) and the int8 KV cache (``kv_cache_dtype="int8"``)
are model options: both engines are built with them on the same weights.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.serving import ServingConfig as JaxServingConfig
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serving import (
    EngineOverloaded,
    ServingConfig,
    ServingEngine,
    ServingServer,
)
from kubeflow_tpu_torch.serving.server import build_server, env_config
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

MAX_SEQ = 64


@pytest.fixture(scope="module")
def shared():
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    params = jax.tree.map(lambda x: x * 8 if x.ndim >= 2 else x, params)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ)
    return jmodel, params, tcfg, llama_params_from_jax(params, tcfg)


def port_engine(shared, model_kw=None, **kw):
    _, _, tcfg, sd = shared
    model = Llama(dataclasses.replace(tcfg, **(model_kw or {})))
    model.load_state_dict(sd)
    return ServingEngine(model, ServingConfig(param_dtype="", **kw),
                         device="cpu", registry=MetricsRegistry())


def jax_engine(shared, model_kw=None, **kw):
    jmodel, params, _, _ = shared
    if model_kw:
        jmodel = JaxLlama(dataclasses.replace(jmodel.cfg, **model_kw))
    return JaxServingEngine(jmodel, params,
                            JaxServingConfig(param_dtype="", **kw),
                            registry=JaxRegistry())


def serve(engine, requests):
    rids = [engine.submit(p, **kw) for p, kw in requests]
    engine.run()
    return [engine.result(r) for r in rids]


SCENARIOS = {
    # More requests than slots, mixed buckets: continuous batching.
    "continuous_batching": (
        dict(max_batch=2, max_len=64, prefill_buckets=(8, 16, 32),
             logprobs=True),
        [([5, 9, 2], dict(max_new_tokens=6)),
         ([7] * 7, dict(max_new_tokens=9)),
         (list(range(30, 42)), dict(max_new_tokens=4)),
         (list(range(100, 120)), dict(max_new_tokens=8)),
         ([250, 1, 3, 3, 7], dict(max_new_tokens=10))]),
    # A prompt longer than the largest bucket takes chunked prefill.
    "chunked_prefill": (
        dict(max_batch=2, max_len=64, prefill_buckets=(8, 16)),
        [(list(range(3, 43)), dict(max_new_tokens=6)),
         ([11, 12, 13, 14, 15], dict(max_new_tokens=6))]),
    # Chained chunks (depth 2, chunk 4) run the long request to the cache
    # cap, so speculative positions pass max_len - 1 (RoPE and the cache
    # write clamp), while the short request's idle slot keeps decoding
    # until its cache_index runs far past max_len.
    "chained_past_max_len": (
        dict(max_batch=2, max_len=64, prefill_buckets=(8, 16),
             decode_chunk=4, pipeline_depth=2),
        [([4, 8, 15, 16, 23, 42], dict(max_new_tokens=80)),
         ([1, 2, 3], dict(max_new_tokens=2))]),
}


def assert_same_results(got, want, kw):
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.finished_reason == w.finished_reason
        assert g.prompt_len == w.prompt_len
        if kw.get("logprobs"):
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_greedy_tokens_match_jax_engine(shared, name):
    kw, requests = SCENARIOS[name]
    got = serve(port_engine(shared, **kw), requests)
    want = serve(jax_engine(shared, **kw), requests)
    assert_same_results(got, want, kw)
    if name == "chained_past_max_len":
        assert len(got[0].tokens) == 64 - 1 - 6   # retired at the cap


# decode_staging = decode_chunk, as the JAX server builds it; the int8 KV
# cache alone and staged.
CACHE_OPTIONS = {
    "staged": lambda kw: {"decode_staging": kw.get("decode_chunk", 1)},
    "int8": lambda kw: {"kv_cache_dtype": "int8"},
    "int8_staged": lambda kw: {"kv_cache_dtype": "int8",
                               "decode_staging": kw.get("decode_chunk", 1)},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("option", sorted(CACHE_OPTIONS))
def test_cache_options_match_jax_engine(shared, option, name):
    kw, requests = SCENARIOS[name]
    model_kw = CACHE_OPTIONS[option](kw)
    port = port_engine(shared, model_kw, **kw)
    got = serve(port, requests)
    want = serve(jax_engine(shared, model_kw, **kw), requests)
    assert_same_results(got, want, kw)
    layer = port._cache[0]
    if "kv_cache_dtype" in model_kw:
        assert layer["cached_key"].dtype == torch.int8
        assert layer["key_scale"].dtype == torch.float32
    assert ("stage_key" in layer) == ("decode_staging" in model_kw)


# Weight-only int8 (quantize_min_size=64 reaches llama-tiny's projections),
# alone and with the int8 staged KV cache: both engines dequantize each
# weight to bf16 (_materialize's rounding point) and multiply in f32.
INT8_WEIGHTS = dict(quantize="int8", quantize_min_size=64)


@pytest.mark.parametrize("name", ["continuous_batching", "chunked_prefill"])
@pytest.mark.parametrize("option", ["bf16_cache", "int8_staged"])
def test_int8_weights_match_jax_engine(shared, option, name):
    kw, requests = SCENARIOS[name]
    model_kw = ({} if option == "bf16_cache"
                else CACHE_OPTIONS[option](kw))
    port = port_engine(shared, model_kw, **INT8_WEIGHTS, **kw)
    got = serve(port, requests)
    want = serve(jax_engine(shared, model_kw, **INT8_WEIGHTS, **kw),
                 requests)
    assert_same_results(got, want, kw)
    assert len(port.quantized) == 7 * port.model.cfg.num_layers + 1
    assert port.model.lm_head.weight.dtype == torch.int8


def test_unknown_quantize_refused(shared):
    with pytest.raises(ValueError, match="quantize"):
        ServingConfig(quantize="fp4")
    with pytest.raises(ValueError, match="quantize"):
        port_engine(shared, max_batch=1, max_len=64, quantize="fp4")


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_staged_matches_unstaged(shared, kv_dtype):
    """Chunk 4 and 11 tokens: two flushes fall inside each generation."""
    kw = dict(max_batch=2, max_len=64, decode_chunk=4, prefill_buckets=(8,))
    requests = [([3, 1, 4, 1, 5], dict(max_new_tokens=11)),
                ([2, 7, 1], dict(max_new_tokens=11))]
    out = {}
    for staging in (0, 4):
        eng = port_engine(shared, {"kv_cache_dtype": kv_dtype,
                                   "decode_staging": staging}, **kw)
        eng.warmup(8)
        out[staging] = [r.tokens for r in serve(eng, requests)]
    assert all(len(t) == 11 for t in out[4])
    assert out[4] == out[0]


def test_chunk_longer_than_staging_refused(shared):
    with pytest.raises(ValueError, match="decode_staging"):
        port_engine(shared, {"decode_staging": 2}, max_batch=2, max_len=64,
                    decode_chunk=4)


def test_eos_stops_like_jax(shared):
    kw = dict(max_batch=1, max_len=64, prefill_buckets=(8, 16))
    prompt = [5, 6, 7]
    free = serve(port_engine(shared, **kw),
                 [(prompt, dict(max_new_tokens=8))])[0].tokens
    req = [(prompt, dict(max_new_tokens=8, eos_token=free[2]))]
    got = serve(port_engine(shared, **kw), req)[0]
    want = serve(jax_engine(shared, **kw), req)[0]
    assert got.finished_reason == want.finished_reason == "eos"
    assert got.tokens == want.tokens == free[:free.index(free[2]) + 1]


def test_serving_metrics_recorded(shared):
    registry = MetricsRegistry()
    _, _, tcfg, sd = shared
    model = Llama(tcfg)
    model.load_state_dict(sd)
    eng = ServingEngine(model, ServingConfig(param_dtype="", max_batch=2,
                                             max_len=64,
                                             prefill_buckets=(8,)),
                        device="cpu", registry=registry)
    serve(eng, [([1, 2, 3], dict(max_new_tokens=3)),
                ([4, 5], dict(max_new_tokens=2)),
                ([6], dict(max_new_tokens=4))])
    ttft = registry.get("kftpu_serving_ttft_seconds")
    assert ttft.count() == 3
    assert {e["trace_id"] for e in ttft.exemplars()} <= {
        "req:0", "req:1", "req:2"}
    text = registry.render()
    assert 'kftpu_serving_requests_total{outcome="admitted"} 3' in text
    assert "kftpu_serving_queue_wait_seconds_count 3" in text
    assert eng.load()["kv_blocks_live"] == 0
    assert eng.prefill_dispatches >= 2      # the third waits for a slot


def test_max_queue_overload(shared):
    eng = port_engine(shared, max_batch=1, max_len=64,
                      prefill_buckets=(8,), max_queue=2)
    eng.submit([1, 2])
    eng.submit([3, 4])
    with pytest.raises(EngineOverloaded) as exc:
        eng.submit([5, 6])
    assert exc.value.retry_after_s >= 1.0
    assert eng.shed_total == 1
    with pytest.raises(ValueError, match="token ids"):
        eng.submit([1, 10_000])


class TestSampler:
    """The on-device sampler on crafted logits, many draws."""

    @pytest.fixture(scope="class")
    def eng(self, shared):
        return port_engine(shared, max_batch=1, max_len=64,
                           sample_candidates=64)

    def _rows(self, eng, logits, samp, n=64):
        rows = [set() for _ in samp]
        for _ in range(n):
            toks, _ = eng._sample_logits(
                torch.tensor(logits, dtype=torch.float32),
                np.asarray(samp, np.float32))
            for r, t in enumerate(toks.tolist()):
                rows[r].add(t)
        return rows

    def test_top_k_and_top_p_support(self, eng):
        rows = self._rows(eng, [[5.0, 4.9, 4.8, -2.0, -3.0, -50.0],
                                [4.0, 3.0, 2.0, -1.0, -1.0, -1.0],
                                [4.0, 3.0, 2.0, -1.0, -1.0, -1.0],
                                [4.0, 3.0, 2.9, 2.8, -1.0, -1.0]],
                          [[3.0, 3.0, 1.0],     # top-k 3
                           [1.0, 0.0, 0.5],     # nucleus {0}
                           [1.0, 0.0, 0.7],     # nucleus {0, 1}
                           [1.0, 2.0, 0.9]])    # top-k 2, then top-p
        assert rows[0] <= {0, 1, 2} and len(rows[0]) > 1
        assert rows[1] == {0}
        assert rows[2] == {0, 1}
        assert rows[3] == {0, 1}

    def test_greedy_rows_stay_greedy_among_sampled(self, eng):
        logits = [[1.0, 5.0, 4.95, 4.9, -9.0, -9.0]] * 3
        rows = self._rows(eng, logits, [[0.0, 0.0, 1.0],    # greedy
                                        [2.0, 2.0, 1.0],    # top-k 2
                                        [5.0, 0.0, 1.0]])   # hot plain
        assert rows[0] == {1}
        assert rows[1] <= {1, 2} and len(rows[1]) == 2
        assert len(rows[2]) >= 3

    def test_plain_row_keeps_full_vocab_in_mixed_batch(self, eng):
        logits = np.zeros((2, 128), np.float32)
        logits[0, :64] = 2.0
        logits[1, 0] = 5.0
        rows = self._rows(eng, logits, [[5.0, 0.0, 1.0], [1.0, 2.0, 1.0]])
        assert any(t >= 64 for t in rows[0])


def _post(base, body):
    req = urllib.request.Request(
        f"{base}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_http_roundtrip_from_env(monkeypatch):
    """build_server from the KFTPU_SERVING_* env on the CPU, then plain
    and streaming /v1/generate, /v1/models and /healthz."""
    for key, value in {
        "KFTPU_PLATFORM": "cpu", "KFTPU_SERVING_MODEL": "llama-tiny",
        "KFTPU_SERVING_MAX_BATCH": "2", "KFTPU_SERVING_MAX_LEN": "64",
        "KFTPU_SERVING_DECODE_CHUNK": "2", "KFTPU_SERVING_PORT": "0",
        "KFTPU_SERVING_HOST": "127.0.0.1",
        "KFTPU_SERVING_PREFILL_BUCKETS": "8,16,32",
        "KFTPU_SERVING_LOGPROBS": "1",
    }.items():
        monkeypatch.setenv(key, value)
    server = build_server(env_config()).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert json.load(urllib.request.urlopen(f"{base}/healthz"))["ok"]
        models = json.load(urllib.request.urlopen(f"{base}/v1/models"))
        assert models["models"][0]["name"] == "llama-tiny"
        prompt = [3, 14, 15, 92, 65]
        out = json.load(_post(base, {"tokens": prompt, "max_new_tokens": 6}))
        assert len(out["tokens"]) == 6
        assert all(0 <= t < 256 for t in out["tokens"])
        assert len(out["logprobs"]) == 6
        assert out["latency_s"] >= out["ttft_s"] > 0
        with _post(base, {"tokens": prompt, "max_new_tokens": 6,
                          "stream": True}) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            chunks = [json.loads(line) for line in r]
        assert chunks[-1]["done"] is True
        assert [t for c in chunks[:-1] for t in c["tokens"]] == out["tokens"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base, {"tokens": [1, 999]})
        assert exc.value.code == 400
    finally:
        server.stop()


@pytest.mark.parametrize("env", ["KFTPU_SERVING_QUANTIZE",
                                 "KFTPU_SERVING_QUANTIZE_KV",
                                 "KFTPU_SERVING_CHECKPOINT_DIR"])
def test_unported_server_options_raise(monkeypatch, tmp_path, env):
    monkeypatch.setenv("KFTPU_PLATFORM", "cpu")
    if env == "KFTPU_SERVING_QUANTIZE":
        # Ported: int8 weights at llama-tiny's (default) sizes quantize
        # nothing (every leaf is under 65536 elements), so the server
        # builds and serves; the unknown scheme raises.
        _tiny_server_env(monkeypatch)
        monkeypatch.setenv(env, "int8")
        server = build_server(env_config())
        assert server.engine.cfg.quantize == "int8"
        assert server.engine.quantized == []
        monkeypatch.setenv(env, "fp4")
        with pytest.raises(ValueError, match="quantize"):
            build_server(env_config())
        return
    if env == "KFTPU_SERVING_CHECKPOINT_DIR":
        # Ported with the training slice: a directory without a complete
        # checkpoint raises instead of serving random weights
        # (tests/test_torch_train.py serves a trained one).
        monkeypatch.setenv(env, str(tmp_path))
        with pytest.raises(RuntimeError, match="no checkpoint found"):
            build_server(env_config())
        return
    monkeypatch.setenv(env, "int8")
    if env == "KFTPU_SERVING_QUANTIZE_KV":
        # Ported: the env reaches the model, which the server builds
        # staged as the JAX server does.
        _tiny_server_env(monkeypatch)
        server = build_server(env_config())
        cfg = server.engine.model.cfg
        assert (cfg.kv_cache_dtype, cfg.decode_staging) == ("int8", 4)
        assert server.engine._cache[0]["cached_value"].dtype == torch.int8
        return
    with pytest.raises(NotImplementedError, match="later|slice"):
        build_server(env_config())


def _tiny_server_env(monkeypatch):
    for key, value in {"KFTPU_SERVING_MODEL": "llama-tiny",
                       "KFTPU_SERVING_MAX_LEN": "64",
                       "KFTPU_SERVING_DECODE_CHUNK": "4",
                       "KFTPU_SERVING_HOST": "127.0.0.1",
                       "KFTPU_SERVING_PORT": "0"}.items():
        monkeypatch.setenv(key, value)


@pytest.mark.parametrize("quantize_kv", ["", "int8"])
def test_int8_server_from_checkpoint(shared, monkeypatch, tmp_path,
                                     quantize_kv):
    """KFTPU_SERVING_QUANTIZE=int8 over a port checkpoint: the server loads
    the trained weights, then quantizes them (the engine's minimum size
    lowered to llama-tiny's), and serves over HTTP."""
    import types

    from kubeflow_tpu_torch.serving import engine as engine_mod
    from kubeflow_tpu_torch.serving.engine import _quantize_leaf
    from kubeflow_tpu_torch.train.checkpoint import CheckpointService

    _, _, tcfg, sd = shared
    ckpt = CheckpointService(str(tmp_path))
    ckpt.save(3, types.SimpleNamespace(params=sd, opt_state={}, step=3))
    ckpt.close()
    _tiny_server_env(monkeypatch)
    for key, value in {"KFTPU_PLATFORM": "cpu",
                       "KFTPU_SERVING_CHECKPOINT_DIR": str(tmp_path),
                       "KFTPU_SERVING_QUANTIZE": "int8",
                       "KFTPU_SERVING_QUANTIZE_KV": quantize_kv}.items():
        monkeypatch.setenv(key, value)
    quantizable = engine_mod._quantizable
    monkeypatch.setattr(engine_mod, "_quantizable",
                        lambda name, p, min_size: quantizable(name, p, 64))
    server = build_server(env_config()).start()
    try:
        model = server.engine.model
        assert model.cfg.kv_cache_dtype == quantize_kv
        o = model.layers[1].attn.o_proj
        want_q, want_s = _quantize_leaf(
            sd["layers.1.attn.o_proj.weight"].to(torch.bfloat16),
            tcfg.head_dim)
        assert torch.equal(o.weight, want_q) and torch.equal(o.scale, want_s)
        assert torch.equal(model.embed, sd["embed"].to(torch.bfloat16))
        out = json.load(_post(f"http://127.0.0.1:{server.port}",
                              {"tokens": [5, 9, 2], "max_new_tokens": 5}))
        assert len(out["tokens"]) == 5
    finally:
        server.stop()


def test_direct_server_wraps_engine(shared):
    engine = port_engine(shared, max_batch=1, max_len=64,
                         prefill_buckets=(8,))
    server = ServingServer(engine, model_name="tiny").start()
    try:
        out = json.load(_post(f"http://127.0.0.1:{server.port}",
                              {"tokens": [1, 2, 3], "max_new_tokens": 3}))
        assert len(out["tokens"]) == 3
    finally:
        server.stop()

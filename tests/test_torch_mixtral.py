"""The port's Mixtral (``models/mixtral.py``) and its serving path against
the JAX package's, on JAX-initialised weights.

f32 logits agree to atol 1e-4, the Llama tests' tolerance; the weight
conversion round trip is bitwise for the unrolled and the scanned tree.
The port's engine gives the JAX engine's greedy tokens, dense and paged,
on mixtral-tiny in the setup of tests/test_serving.py's TestMoEServing
(decode chunks of 4, prefill buckets of 8 and 16), with 8 slots, a capacity
factor of 1.0 (capacity 4 at a decode step of 8 rows) and weights that
send most first choices to expert 0, so that capacity drops tokens at
every decode step and at the k-padded prefill (6 prompts padded to 8
rows; a seventh, past the largest bucket, takes the chunked extend):
routing depends on every row fed, so the tokens agree only when the two
engines feed the same rows.
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

from kubeflow_tpu.models import Mixtral as JaxMixtral
from kubeflow_tpu.models import MixtralConfig as JaxMixtralConfig
from kubeflow_tpu.serving import ServingConfig as JaxServingConfig
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Mixtral, MixtralConfig, get_model
from kubeflow_tpu_torch.models.convert import (
    mixtral_params_from_jax,
    mixtral_params_to_jax,
)
from kubeflow_tpu_torch.models.llama import int8_launches_per_pass
from kubeflow_tpu_torch.models.mixtral import MoeMlp
from kubeflow_tpu_torch.ops.moe import route_reference
from kubeflow_tpu_torch.parallel import moe as pmoe
from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
from kubeflow_tpu_torch.serving.server import build_server, env_config
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

TOKENS = np.random.RandomState(0).randint(0, 256, (2, 24))


def _jax_params(jcfg):
    params = jax.device_get(nn.meta.unbox(jax.jit(JaxMixtral(jcfg).init)(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    return {"params": params["params"]}


@pytest.fixture(scope="module")
def jax_params():
    """mixtral-tiny's JAX params, unrolled (the routing options below
    change no parameter)."""
    return _jax_params(JaxMixtralConfig.tiny(dtype=jnp.float32))


@pytest.fixture(scope="module")
def unrolled(jax_params):
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32)
    params = jax_params
    tcfg = MixtralConfig.tiny(dtype=torch.float32)
    model = Mixtral(tcfg)
    model.load_state_dict(mixtral_params_from_jax(params, tcfg))
    return JaxMixtral(jcfg), params, model


def test_registry_and_published_config():
    with torch.device("meta"):
        model, cfg = get_model("mixtral-8x7b")
    assert isinstance(model, Mixtral) and isinstance(cfg, MixtralConfig)
    want = JaxMixtralConfig.mixtral_8x7b()
    for f in ("vocab_size", "embed_dim", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "mlp_dim", "rope_theta",
              "num_experts", "capacity_factor", "aux_loss_weight",
              "moe_dispatch"):
        assert getattr(cfg, f) == getattr(want, f), f
    assert model.layers[0].mlp.w_gate.shape == (8, 4096, 14336)
    assert model.layers[0].mlp.w_down.shape == (8, 14336, 4096)
    model, cfg = get_model("mixtral-tiny", param_dtype="bfloat16")
    assert (cfg.num_experts, cfg.capacity_factor) == (4, 2.0)
    assert model.layers[1].mlp.w_up.dtype == torch.bfloat16
    assert int8_launches_per_pass(model) == 0


def test_f32_logits_match_jax(unrolled):
    jmodel, params, model = unrolled
    want, _ = jax.jit(lambda p, t: jmodel.apply(p, t, mutable=["losses"]))(
        params, jnp.asarray(TOKENS))
    with torch.no_grad():
        got = model(torch.from_numpy(TOKENS))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("scanned", [False, True])
def test_param_round_trip_is_bitwise(unrolled, scanned):
    if scanned:
        jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32, scan_layers=True)
        params = _jax_params(jcfg)
        assert "layers" in params["params"]
    else:
        params = unrolled[1]
    tcfg = MixtralConfig.tiny(dtype=torch.float32, scan_layers=scanned)
    model = Mixtral(tcfg)
    model.load_state_dict(mixtral_params_from_jax(params, tcfg))
    back = mixtral_params_to_jax(model.state_dict(), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------- serving

MODEL_KW = dict(capacity_factor=1.0, max_seq_len=64)
SERVE_KW = dict(max_batch=8, max_len=64, decode_chunk=4,
                prefill_buckets=(8, 16))
PAGED = ({"paged_kv_blocks": 64, "paged_kv_block_size": 8},
         {"kv_blocks": 64, "kv_block_size": 8})
# Six prompts of one bucket (a prefill padded to 8 rows) and one past the
# largest bucket (the chunked-prefill extend, 16 tokens a chunk).
REQUESTS = [([3, 1, 4, 1, 5], 6), ([9, 2, 6], 6), ([5, 3, 5, 8, 9, 7, 9], 6),
            ([2, 7, 1, 8, 2, 8], 5), ([1, 1, 2], 7), ([4, 4], 6),
            (list(range(30, 50)), 5)]


@pytest.fixture(scope="module")
def served(jax_params):
    """mixtral-tiny's weights x8 (sharp attention, varied tokens), the
    embedding's first column raised and each router's expert 0 weighted on
    it: most first choices go to expert 0."""
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32, **MODEL_KW)
    params = jax.tree.map(lambda x: x * 8 if x.ndim >= 2 else x, jax_params)
    p = params["params"]
    p["embed"] = p["embed"].copy()
    p["embed"][:, 0] += 0.5
    for i in range(jcfg.num_layers):
        router = p[f"layer_{i}"]["moe"]["router"]
        router["kernel"] = router["kernel"].copy()
        router["kernel"][0, 0] += 4.0
    tcfg = MixtralConfig.tiny(dtype=torch.float32, **MODEL_KW)
    return jcfg, params, tcfg, mixtral_params_from_jax(params, tcfg)


def _serve(engine):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    engine.run()
    return [engine.result(r).tokens for r in rids]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_jax_engine_with_drops(served, monkeypatch,
                                                   paged):
    jcfg, params, tcfg, sd = served
    model_kw, serve_kw = PAGED if paged else ({}, {})
    want = _serve(JaxServingEngine(
        JaxMixtral(dataclasses.replace(jcfg, **model_kw)), params,
        JaxServingConfig(param_dtype="", **SERVE_KW, **serve_kw),
        registry=JaxRegistry()))
    # Count each routing's rows and trash destinations (plain version).
    routed = []

    def counting(logits, groups, capacity, dtype):
        r = route_reference(logits, groups, capacity, dtype)
        trash = logits.shape[1] * groups * capacity
        routed.append((logits.shape[0],
                       int((r.dest1 == trash).sum() + (r.dest2 == trash).sum())))
        return r

    monkeypatch.setattr(pmoe, "route", counting)
    model = Mixtral(dataclasses.replace(tcfg, **model_kw))
    model.load_state_dict(sd)
    engine = ServingEngine(model, ServingConfig(param_dtype="", **SERVE_KW,
                                                **serve_kw),
                           device="cpu", registry=MetricsRegistry())
    got = _serve(engine)
    assert got == want
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    # Two extend chunks of 16 tokens, one prefill of the 6 short prompts
    # padded to 8 rows (64 tokens), then decode steps of 8 rows, most of
    # them dropping a choice (each routing once a layer).
    rows = [r for r, _ in routed]
    assert rows.count(16) == 2 * 2 and rows.count(64) == 2
    assert all(d > 0 for r, d in routed if r == 64)
    decode = [d for r, d in routed if r == 8]
    assert len(decode) >= 2 * 5 and sum(d > 0 for d in decode) > \
        len(decode) // 2


def test_server_serves_mixtral_tiny(monkeypatch):
    for key, value in {
        "KFTPU_PLATFORM": "cpu", "KFTPU_SERVING_MODEL": "mixtral-tiny",
        "KFTPU_SERVING_MAX_BATCH": "2", "KFTPU_SERVING_MAX_LEN": "64",
        "KFTPU_SERVING_DECODE_CHUNK": "2", "KFTPU_SERVING_PORT": "0",
        "KFTPU_SERVING_HOST": "127.0.0.1",
        "KFTPU_SERVING_PREFILL_BUCKETS": "8,16",
    }.items():
        monkeypatch.setenv(key, value)
    server = build_server(env_config()).start()
    try:
        assert isinstance(server.engine.model, Mixtral)
        base = f"http://127.0.0.1:{server.port}"
        models = json.load(urllib.request.urlopen(f"{base}/v1/models"))
        assert models["models"][0]["name"] == "mixtral-tiny"
        req = urllib.request.Request(
            f"{base}/v1/generate", data=json.dumps(
                {"tokens": [3, 14, 15, 92, 65], "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.load(urllib.request.urlopen(req, timeout=60))
        assert len(out["tokens"]) == 5
        assert all(0 <= t < 256 for t in out["tokens"])
    finally:
        server.stop()


def test_unported_paths_raise(unrolled):
    """Training and remat run on a Mixtral model (the trainer takes it,
    a remat forward gives the plain forward's logits); router jitter
    still raises, naming the item that keeps it open."""
    _, _, model = unrolled
    trainer = Trainer(Mixtral(model.cfg), TrainConfig(), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(model.state_dict())
    _, metrics = trainer.step(state, {"inputs": torch.from_numpy(TOKENS)})
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["aux_loss"]) > 0.5
    remat = Mixtral(dataclasses.replace(model.cfg, remat=True))
    remat.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = model(torch.from_numpy(TOKENS))
    assert torch.equal(remat(torch.from_numpy(TOKENS)), want)
    assert isinstance(remat.layers[0].mlp, MoeMlp)
    with pytest.raises(NotImplementedError, match="6c"):
        Trainer(Mixtral(dataclasses.replace(model.cfg, router_jitter=0.1)),
                TrainConfig(), device="cpu")

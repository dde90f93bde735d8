"""The port's Llama against the JAX package's, with JAX-initialised weights.

f32 logits agree to atol 1e-4; bf16 logits to atol 5e-2 (the two
frameworks round bf16 at slightly different places inside fused ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.models.llama import head_logits as jax_head_logits
from kubeflow_tpu_torch.models import Llama, LlamaConfig, get_model, list_models
from kubeflow_tpu_torch.models.convert import (
    llama_params_from_jax,
    llama_params_to_jax,
)

TOKENS = np.random.RandomState(0).randint(0, 256, (2, 24))


def _pair(jdtype, tdtype, **kw):
    jcfg = JaxLlamaConfig.tiny(dtype=jdtype, **kw)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    tcfg = LlamaConfig.tiny(dtype=tdtype, **kw)
    model = Llama(tcfg)
    model.load_state_dict(llama_params_from_jax(params, tcfg))
    return jmodel, params, model


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(jnp.float32, torch.float32)


def test_param_round_trip_is_bitwise(f32_pair):
    _, params, model = f32_pair
    back = llama_params_to_jax(model.state_dict(), model.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("attn_impl", ["flash", "full"])
def test_f32_logits_match_jax(f32_pair, attn_impl):
    jmodel, params, model = f32_pair
    want = np.asarray(jmodel.apply(params, jnp.asarray(TOKENS)))
    with torch.no_grad():
        got = model(torch.from_numpy(TOKENS), attn_impl=attn_impl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_prefill_then_decode_matches_full_forward(f32_pair):
    _, _, model = f32_pair
    toks = torch.from_numpy(TOKENS)
    P = 10
    with torch.no_grad():
        full = model(toks)
        cache = model.init_cache(2, 32)
        logits = [model(toks[:, :P], cache=cache, decode="prefill")[0]]
        for t in range(P, TOKENS.shape[1]):
            pos = torch.full((2, 1), t)
            out, cache = model(toks[:, t:t + 1], positions=pos, cache=cache,
                               decode=True)
            logits.append(out)
    got = torch.cat(logits, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-4, rtol=0)
    assert cache[0]["cache_index"].tolist() == [TOKENS.shape[1]] * 2


def test_bf16_logits_match_jax():
    jmodel, params, model = _pair(jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jmodel.apply(params, jnp.asarray(TOKENS)))
    with torch.no_grad():
        got = model(torch.from_numpy(TOKENS))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)


def test_head_logits_tied_softcap_matches_jax():
    jmodel, params, model = _pair(jnp.float32, torch.float32,
                                  tie_embeddings=True, logits_softcap=3.0)
    x = np.random.RandomState(1).randn(2, 3, 64).astype(np.float32)
    want = jax_head_logits(jmodel.cfg, params["params"], jnp.asarray(x))
    with torch.no_grad():
        got = model.head_logits(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("flag,value", [
    ("fused_qkv", True), ("fused_gate_up", True), ("kv_cache_dtype", "int8"),
    ("decode_staging", 8), ("paged_kv_blocks", 64), ("pipeline_stages", 2),
])
def test_unported_options_raise(flag, value):
    with pytest.raises(NotImplementedError, match=flag):
        Llama(LlamaConfig.tiny(**{flag: value}))


def test_scanned_tree_raises():
    cfg = LlamaConfig.tiny()
    with pytest.raises(NotImplementedError, match="scanned"):
        llama_params_from_jax({"params": {"embed": np.zeros((256, 64)),
                                          "layers": {}}}, cfg)


def test_registry_names():
    assert list_models() == ["llama-tiny", "llama3-70b", "llama3-8b"]
    model, cfg = get_model("llama-tiny", param_dtype="bfloat16")
    assert cfg.param_dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16
    cfg8b = LlamaConfig.llama3_8b()
    assert (cfg8b.num_layers, cfg8b.embed_dim, cfg8b.vocab_size,
            cfg8b.num_heads, cfg8b.num_kv_heads) == (32, 4096, 128256, 32, 8)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("mixtral-tiny")

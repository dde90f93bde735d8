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

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

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
    ("remat_policy", "minimal"),
])
def test_unported_options_raise(flag, value):
    if flag in ("fused_qkv", "fused_gate_up", "remat_policy"):
        # Ported with the fused-projection slice: the model builds with the
        # fused parameters in place of those they fuse (G = H / Hkv = 2),
        # and every remat policy builds.
        model = Llama(LlamaConfig.tiny(**{flag: value}, remat=True))
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        fused = {"fused_qkv": ("attn.qkv_proj", (2 * 4 * 16, 64),
                               ("attn.q_proj", "attn.k_proj", "attn.v_proj")),
                 "fused_gate_up": ("mlp.gate_up_proj", (2 * 128, 64),
                                   ("mlp.gate_proj", "mlp.up_proj"))}
        if flag in fused:
            name, shape, gone = fused[flag]
            assert shapes[f"layers.0.{name}.weight"] == shape
            assert not any(f"layers.0.{g}.weight" in shapes for g in gone)
        else:
            assert "layers.0.attn.q_proj.weight" in shapes
        return
    if flag in ("kv_cache_dtype", "decode_staging", "paged_kv_blocks"):
        # Ported with the serving slices: the model builds, and its cache
        # holds the int8 rows and scales, the staging rows, or the paged
        # pool (the blocks plus the scratch page, of 16 rows each).
        cache = Llama(LlamaConfig.tiny(**{flag: value})).init_cache(2, 16)[0]
        if flag == "kv_cache_dtype":
            assert cache["cached_key"].dtype == torch.int8
            assert cache["key_scale"].shape == (2, 16, 2, 1)
        elif flag == "paged_kv_blocks":
            assert cache["cached_key"].shape == (value + 1, 16, 2, 16)
        else:
            assert cache["stage_key"].shape == (2, value, 2, 16)
        return
    # A remat policy is only read with remat on, as in the JAX model.
    extra = {"remat": True} if flag == "remat_policy" else {}
    with pytest.raises(NotImplementedError, match=flag):
        Llama(LlamaConfig.tiny(**{flag: value}, **extra))


def test_scanned_tree_raises():
    # Scanned trees (one "layers" subtree stacked over depth, as the JAX
    # bench trains) now convert, bitwise equal to their unrolled form.
    from kubeflow_tpu.models.layout import to_layer_layout

    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, scan_layers=True)
    params = jax.device_get(nn.meta.unbox(JaxLlama(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    assert "layers" in params["params"]
    cfg = LlamaConfig.tiny()
    got = llama_params_from_jax(params, cfg)
    want = llama_params_from_jax(
        to_layer_layout(params["params"], cfg.num_layers), cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="stacked layers"):
        llama_params_from_jax(params, LlamaConfig.tiny(num_layers=3))


def test_registry_names():
    assert list_models() == ["llama-tiny", "llama3-70b", "llama3-8b",
                             "mixtral-8x7b", "mixtral-tiny", "resnet-tiny",
                             "resnet101", "resnet50", "vit-b16", "vit-l16",
                             "vit-tiny"]
    model, cfg = get_model("llama-tiny", param_dtype="bfloat16")
    assert cfg.param_dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16
    cfg8b = LlamaConfig.llama3_8b()
    assert (cfg8b.num_layers, cfg8b.embed_dim, cfg8b.vocab_size,
            cfg8b.num_heads, cfg8b.num_kv_heads) == (32, 4096, 128256, 32, 8)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("bert-tiny")

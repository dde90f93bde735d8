"""The fused projections (``fused_qkv``, ``fused_gate_up``) of the port's
Llama against the JAX package's, on the CPU.

A 2-layer llama-tiny (G = H / Hkv = 2) with JAX-initialised weights,
converted by ``models/convert.py``: logits and every parameter's gradient
within 1e-5 (f32; the reductions run in another order), for each
combination of the two flags; the ``H % Hkv != 0`` fallback to separate
projections, as the JAX branch falls back; the conversion both ways,
unrolled and stacked, bitwise; and the tiny serving engine with both
flags (dense cache, int8 weights, paged pool) giving the JAX engine's
greedy tokens, as tests/test_torch_serving.py holds the unfused engine.
"""

import dataclasses

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
from kubeflow_tpu.train import losses as jlosses
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import (
    llama_params_from_jax,
    llama_params_to_jax,
)
from kubeflow_tpu_torch.models.llama import int8_launches_per_pass
from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
from kubeflow_tpu_torch.train import losses as tlosses
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

V = 256
TOKENS = np.random.RandomState(5).randint(0, V, (2, 17))
FLAGS = [(True, False), (False, True), (True, True)]


def _flags(fq, fg):
    return dict(fused_qkv=fq, fused_gate_up=fg)


def _jax(**kw):
    jmodel = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **kw))
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    return jmodel, params


@pytest.mark.parametrize("fq,fg", FLAGS)
def test_logits_and_grads_match_jax(fq, fg):
    jmodel, params = _jax(**_flags(fq, fg))
    attn = params["params"]["layer_0"]["attn"]
    mlp = params["params"]["layer_0"]["mlp"]
    assert ("qkv_proj" in attn) == fq and ("gate_up_proj" in mlp) == fg
    inputs, labels = TOKENS[:, :-1], TOKENS[:, 1:]

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(inputs))
        return jlosses.cross_entropy_loss(logits, jnp.asarray(labels),
                                          z_loss_weight=1e-4)[0], logits

    (want_loss, want_logits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    cfg = LlamaConfig.tiny(dtype=torch.float32, **_flags(fq, fg))
    model = Llama(cfg)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    logits = model(torch.from_numpy(inputs))
    loss, _ = tlosses.cross_entropy_loss(logits, torch.from_numpy(labels),
                                         z_loss_weight=1e-4)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6)
    want = llama_params_from_jax(jax.device_get(jgrads), cfg)
    assert want.keys() == dict(model.named_parameters()).keys()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_uneven_heads_fall_back_to_separate_projections():
    # H % Hkv != 0: both models build the three projections, as the JAX
    # branch requires (kubeflow_tpu/models/llama.py:256).
    cfg = LlamaConfig.tiny(num_heads=6, num_kv_heads=4, fused_qkv=True,
                           fused_gate_up=True)
    names = {n for n, _ in Llama(cfg).named_parameters()}
    assert {"layers.0.attn.q_proj.weight", "layers.0.attn.k_proj.weight",
            "layers.0.attn.v_proj.weight",
            "layers.0.mlp.gate_up_proj.weight"} <= names
    assert not any("qkv_proj" in n for n in names)
    sd = {n: torch.zeros(p.shape) for n, p in Llama(cfg).named_parameters()}
    tree = llama_params_to_jax(sd, cfg)["params"]["layer_0"]["attn"]
    assert sorted(tree) == ["k_proj", "o_proj", "q_proj", "v_proj"]
    assert tree["q_proj"]["kernel"].shape == (64, 6, 16)


@pytest.mark.parametrize("scan", [False, True])
def test_convert_round_trip_is_bitwise(scan):
    _, params = _jax(scan_layers=scan, fused_qkv=True, fused_gate_up=True)
    cfg = LlamaConfig.tiny(dtype=torch.float32, scan_layers=scan,
                           fused_qkv=True, fused_gate_up=True)
    sd = llama_params_from_jax(params, cfg)
    assert sd["layers.1.attn.qkv_proj.weight"].shape == (2 * 4 * 16, 64)
    assert sd["layers.1.mlp.gate_up_proj.weight"].shape == (2 * 128, 64)
    Llama(cfg).load_state_dict(sd)               # the port's own names
    back = llama_params_to_jax(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_fused_rows_are_the_separate_rows_interleaved():
    """The fused kernels' output order (kv head, slot, d) and (slot, f): a
    fused model whose rows are the separate model's, interleaved, gives
    its logits bitwise."""
    sep = Llama(LlamaConfig.tiny(dtype=torch.float32))
    sep.init_weights(torch.Generator().manual_seed(3))
    fused = Llama(LlamaConfig.tiny(dtype=torch.float32, fused_qkv=True,
                                   fused_gate_up=True))
    sd = sep.state_dict()
    for i in range(2):
        pre = f"layers.{i}."
        q, k, v = (sd.pop(pre + f"attn.{n}_proj.weight").view(2, -1, 16, 64)
                   for n in "qkv")
        sd[pre + "attn.qkv_proj.weight"] = torch.cat([q, k, v], 1).reshape(
            -1, 64)
        sd[pre + "mlp.gate_up_proj.weight"] = torch.cat(
            [sd.pop(pre + "mlp.gate_proj.weight"),
             sd.pop(pre + "mlp.up_proj.weight")])
    fused.load_state_dict(sd)
    toks = torch.from_numpy(TOKENS)
    with torch.no_grad():
        assert torch.equal(fused(toks), sep(toks))


# ------------------------------------------------------------ serving

MAX_SEQ = 64
FUSED = dict(fused_qkv=True, fused_gate_up=True)
# Three requests for two slots: buckets 8 and 16, and one past the largest
# bucket (chunked prefill).
TRACE = [([5, 9, 2], 6), (list(range(30, 42)), 4), (list(range(3, 43)), 6)]
ENGINES = {
    "dense": ({}, {}),
    "int8_weights": ({}, dict(quantize="int8", quantize_min_size=64)),
    "paged": ({"paged_kv_blocks": 32, "paged_kv_block_size": 8},
              {"kv_blocks": 32, "kv_block_size": 8}),
}


@pytest.fixture(scope="module")
def fused_weights():
    jmodel, params = _jax(max_seq_len=MAX_SEQ, **FUSED)
    # Projections x8: sharp attention, greedy choices far apart (as
    # tests/test_torch_serving.py scales them).
    params = jax.tree.map(lambda x: x * 8 if x.ndim >= 2 else x, params)
    return jmodel, params


def _serve(engine):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in TRACE]
    engine.run()
    return [engine.result(r).tokens for r in rids]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_fused_engine_tokens_match_jax_engine(fused_weights, name):
    jmodel, params = fused_weights
    model_kw, kw = ENGINES[name]
    kw = dict(param_dtype="", max_batch=2, max_len=MAX_SEQ,
              prefill_buckets=(8, 16), **kw)
    cfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                           **FUSED, **model_kw)
    model = Llama(cfg)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    port = ServingEngine(model, ServingConfig(**kw), device="cpu",
                         registry=MetricsRegistry())
    jeng = JaxServingEngine(
        JaxLlama(dataclasses.replace(jmodel.cfg, **model_kw)), params,
        JaxServingConfig(**kw), registry=JaxRegistry())
    assert _serve(port) == _serve(jeng)
    if name == "int8_weights":
        # One int8 product a fused projection: 4 a layer and the lm_head.
        assert len(port.quantized) == 4 * cfg.num_layers + 1
        assert port.model.layers[0].attn.qkv_proj.scale.shape == (128, 1)
        assert int8_launches_per_pass(port.model) == 4 * cfg.num_layers + 1

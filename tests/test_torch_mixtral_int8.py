"""The port's int8 Mixtral (expert leaves through K15's plain version)
against the JAX engine's, on mixtral-tiny with ``quantize_min_size=4096``
on both engines: the expert leaves [4, 64, 128] (32768 elements), q, o and
the lm_head quantize; k and v [64, 32] and the router [64, 4] stay as they
are, so q/k/v run as separate products (a mixed group).

- ``serving/engine.py::_quantize_int8`` against the JAX engine's
  ``(params, _scales)``: every leaf bitwise through
  ``models/convert.py::quantized_params_from_jax``, the expert leaves
  [E, K, N] with scales [1, K, N] (one an element, reduced over the
  experts) transposed into the port's [E, N, K] and [1, N, K].
- ``ops/int8_experts.py::int8_experts_reference`` against the JAX expert
  einsum on ``_materialize``'s leaf: in bf16 within 1e-2 x max|JAX| (the
  outputs are rounded to bf16 once, after sums in another order: a bf16
  ulp is 2^-8 of the value), in f32 within atol 1e-5 (the f32 engine keeps
  the dequantized leaf unrounded, as the port's f32 path does).
- ``serving/engine.py::init_int8`` (the streaming build) against
  ``init_weights`` then ``_quantize_int8`` from one seed: bitwise.
- The port's int8 engine, dense and paged, gives the JAX int8 engine's
  greedy tokens in tests/test_torch_mixtral.py's capacity-drop setup (the
  JAX engine over its dense cache: its paged engine's tokens vary from
  run to run in one process, see ``jax_int8_tokens``).

The kernel (K15) runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import Mixtral as JaxMixtral
from kubeflow_tpu.serving import ServingConfig as JaxServingConfig
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Mixtral, MixtralConfig
from kubeflow_tpu_torch.models.convert import quantized_params_from_jax
from kubeflow_tpu_torch.models.llama import Int8Dense, int8_launches_per_pass
from kubeflow_tpu_torch.models.mixtral import (
    Int8Experts,
    expert_launches_per_pass,
)
from kubeflow_tpu_torch.ops.int8_experts import (
    dequantize_experts,
    int8_experts,
    int8_experts_reference,
)
from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine, init_int8
from kubeflow_tpu_torch.serving.engine import _quantize_int8
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry
from test_torch_mixtral import (  # noqa: F401  (fixtures)
    PAGED,
    REQUESTS,
    SERVE_KW,
    _serve,
    jax_params,
    served,
)

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

MIN_SIZE = 4096
INT8 = dict(quantize="int8", quantize_min_size=MIN_SIZE)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


@pytest.fixture(scope="module")
def quantized(served):
    """The JAX int8 engine on the served weights and its trees converted,
    and the port's model quantized by its engine's rules."""
    jcfg, params, tcfg, sd = served
    eng = JaxServingEngine(
        JaxMixtral(jcfg), params,
        JaxServingConfig(param_dtype="", max_batch=1, max_len=64, **INT8),
        registry=JaxRegistry())
    want = quantized_params_from_jax(jax.device_get(eng.params),
                                     jax.device_get(eng._scales), tcfg)
    model = Mixtral(tcfg)
    model.load_state_dict(sd)
    model.requires_grad_(False)
    names = _quantize_int8(model, MIN_SIZE)
    return eng, want, model, names


def test_quantize_matches_jax_engine_bitwise(quantized, served):
    eng, want, model, names = quantized
    tcfg = served[2]
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        assert _same_bits(got[key], w), key
    L, E, M, F = (tcfg.num_layers, tcfg.num_experts, tcfg.embed_dim,
                  tcfg.mlp_dim)
    # q, o, three expert leaves a layer and the lm_head; k, v and the
    # router stay bf16 (below the minimum size).
    assert len(names) == 5 * L + 1
    mlp = model.layers[0].mlp
    assert isinstance(mlp.w_gate, Int8Experts)
    assert mlp.w_gate.weight.shape == (E, F, M)
    assert mlp.w_gate.scale.shape == (1, F, M)
    assert mlp.w_down.weight.shape == (E, M, F)
    assert mlp.w_down.scale.shape == (1, M, F)
    jscale = np.asarray(eng._scales["params"]["layer_0"]["moe"]["w_gate"])
    assert jscale.shape == (1, M, F)
    assert not isinstance(model.layers[0].attn.k_proj, Int8Dense)
    assert not isinstance(mlp.router, Int8Dense)
    assert int8_launches_per_pass(model) == 2 * L + 1
    assert expert_launches_per_pass(model) == 3 * L


def test_experts_reference_matches_jax_einsum(quantized, served):
    eng, _, model, _ = quantized
    deq = jax.device_get(eng._materialize(eng.params))["params"]
    rs = np.random.RandomState(0)
    for n, eq in (("w_gate", "ecm,emh->ech"), ("w_down", "ech,ehm->ecm")):
        leaf = getattr(model.layers[1].mlp, n)
        wj = deq["layer_1"]["moe"][n]                     # bf16 [E, K, N]
        assert wj.dtype == jnp.bfloat16
        assert _same_bits(dequantize_experts(leaf.weight, leaf.scale),
                          torch.from_numpy(np.asarray(wj, np.float32))
                          .bfloat16().transpose(1, 2))
        E, K = wj.shape[:2]
        x = rs.standard_normal((E, 5, K)).astype(np.float32)
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            @jax.jit
            def product(params, x, n=n, eq=eq, jdt=jdt):
                w = eng._materialize(params)["params"]["layer_1"]["moe"][n]
                return jnp.einsum(eq, x, w.astype(jdt),
                                  preferred_element_type=jnp.float32
                                  ).astype(jdt)

            ref = np.asarray(product(eng.params, jnp.asarray(x, jdt)),
                             np.float32)
            xt = torch.from_numpy(x).to(dt)
            got = int8_experts_reference(xt, leaf.weight, leaf.scale)
            assert got.dtype == dt
            assert torch.equal(int8_experts(xt, leaf.weight, leaf.scale), got)
            if dt == torch.float32:                  # the model's dtype
                assert torch.equal(leaf(xt), got)
            tol = 1e-2 * np.abs(ref).max() if dt == torch.bfloat16 else 1e-5
            np.testing.assert_allclose(got.float().numpy(), ref, atol=tol,
                                       rtol=0, err_msg=f"{n} {dt}")


def test_streaming_build_equals_build_then_quantize():
    cfg = MixtralConfig.tiny(param_dtype="bfloat16")
    model = Mixtral(cfg)
    model.init_weights(torch.Generator().manual_seed(7))
    model.requires_grad_(False)
    want_names = _quantize_int8(model, MIN_SIZE)
    with torch.device("meta"):
        streamed = Mixtral(cfg)
    names = init_int8(streamed, torch.Generator().manual_seed(7), MIN_SIZE)
    assert names == want_names and len(names) == 5 * cfg.num_layers + 1
    got, want = streamed.state_dict(), model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].device.type == "cpu"
        assert _same_bits(got[key], w), key
    # The engine finds nothing left to quantize and reports the same.
    eng = ServingEngine(streamed, ServingConfig(max_len=64, **INT8),
                        device="cpu", registry=MetricsRegistry())
    assert eng.quantized == names
    assert eng.weight_bytes == sum(
        t.numel() * t.element_size() for t in want.values())


@pytest.fixture(scope="module")
def jax_int8_tokens(served):
    """The JAX int8 engine's greedy tokens for REQUESTS, over its dense
    cache. Its paged engine is not a reference here: with idle slots it
    gives one of two token sets from run to run in one CPU process (their
    junk rows reach the scratch page through one scatter with repeated
    indices, whose order XLA leaves undefined, and their hidden states
    take expert capacity; ROADMAP Queue 3)."""
    jcfg, params, _, _ = served
    return _serve(JaxServingEngine(
        JaxMixtral(jcfg), params,
        JaxServingConfig(param_dtype="", **SERVE_KW, **INT8),
        registry=JaxRegistry()))


@pytest.mark.parametrize("paged", [False, True])
def test_int8_engine_tokens_match_jax_engine(served, jax_int8_tokens, paged):
    _, _, tcfg, sd = served
    model_kw, serve_kw = PAGED if paged else ({}, {})
    model = Mixtral(dataclasses.replace(tcfg, **model_kw))
    model.load_state_dict(sd)
    launches = int8_experts.launches
    engine = ServingEngine(model, ServingConfig(param_dtype="", **SERVE_KW,
                                                **serve_kw, **INT8),
                           device="cpu", registry=MetricsRegistry())
    got = _serve(engine)
    assert got == jax_int8_tokens
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    assert len(engine.quantized) == 5 * tcfg.num_layers + 1
    assert int8_experts.launches == launches       # the CPU launches none


def test_int8_server_streams_the_build(monkeypatch):
    from kubeflow_tpu_torch.serving import server as server_mod
    from kubeflow_tpu_torch.serving.server import build_server, env_config

    calls = []

    def spy(model, generator, *args):
        # The model arrives on the meta device: no weight was made yet.
        calls.append(all(p.is_meta for p in model.parameters()))
        return init_int8(model, generator, *args)

    monkeypatch.setattr(server_mod, "init_int8", spy)
    for key, value in {
        "KFTPU_PLATFORM": "cpu", "KFTPU_SERVING_MODEL": "mixtral-tiny",
        "KFTPU_SERVING_MAX_BATCH": "2", "KFTPU_SERVING_MAX_LEN": "64",
        "KFTPU_SERVING_DECODE_CHUNK": "2", "KFTPU_SERVING_PORT": "0",
        "KFTPU_SERVING_HOST": "127.0.0.1", "KFTPU_SERVING_QUANTIZE": "int8",
    }.items():
        monkeypatch.setenv(key, value)
    server = build_server(env_config())
    engine = server.engine
    assert calls == [True]
    assert engine.cfg.quantize == "int8" and isinstance(engine.model, Mixtral)
    assert not any(t.is_meta for t in engine.model.state_dict().values())
    rid = engine.submit([3, 14, 15, 92, 65], max_new_tokens=3)
    engine.run()
    assert len(engine.result(rid).tokens) == 3

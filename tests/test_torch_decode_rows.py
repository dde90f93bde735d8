"""A decode step's rows: K7's staged mode and K4's SwiGLU epilogue, on the CPU.

- ``ops/rope.py::rope_stage`` and ``rope_stage_fused`` (their plain
  version here) against the JAX model's staged step: ``apply_rope`` on q
  and k, then ``dynamic_update_slice_in_dim`` of ``stage_key`` and
  ``stage_value`` at column ``stage_step``; q/k/v apart and as the fused
  [B, 1, Hkv, G + 2, D] product; bitwise in f32 (both sides given JAX's
  cos/sin tables), the staging tensors compared whole.
- ``Mlp`` with int8 weights at a decode step's rows (M <= 16), which takes
  ``int8_linear_swiglu``, against the JAX ``Mlp`` on the JAX engine's
  ``_materialize``d weights, jitted as the engine's steps are: within
  K4's tolerance, max |port - JAX| <= 1e-2 x max |JAX|; unfused, bitwise
  the port's own int8 products followed by SwiGLU.
- A tiny staged engine (int8 weights, staging = chunk) through both new
  paths: its greedy tokens equal the JAX engine's.

The kernels run only on the card: tests/test_torch_cuda.py holds them
against these plain versions there.
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
from kubeflow_tpu.models.llama import Mlp as JaxMlp
from kubeflow_tpu.ops import rope as jrope
from kubeflow_tpu.serving import ServingConfig as JaxServingConfig
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.serving.engine import _quantize_int8 as jax_quantize_int8
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models import llama as port_llama
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.ops import rope
from kubeflow_tpu_torch.ops.int8_linear import DECODE_MAX_ROWS
from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
from kubeflow_tpu_torch.serving.engine import _quantize_int8
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

FUSED = dict(fused_qkv=True, fused_gate_up=True)


# ------------------------------------------------------------ K7 staged


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_rope_stage_matches_jax_staged_step_bitwise(fused, step):
    rs = np.random.RandomState(7 + step)
    B, Hkv, G, D, C, L = 3, 2, 2, 16, 4, 32
    qkv = rs.randn(B, 1, Hkv, G + 2, D).astype(np.float32)
    stage_k = rs.randn(B, C, Hkv, D).astype(np.float32)
    stage_v = rs.randn(B, C, Hkv, D).astype(np.float32)
    pos = np.array([[5], [31], [40]], np.int32)        # 40: clamped
    jc, js = jrope.rope_frequencies(D, L, theta=500000.0)
    jpos = jnp.asarray(pos)
    jq = jnp.asarray(qkv[..., :G, :].reshape(B, 1, Hkv * G, D))
    jk, jv = jnp.asarray(qkv[..., G, :]), jnp.asarray(qkv[..., G + 1, :])
    want_q = jrope.apply_rope(jq, jc, js, positions=jpos)
    want_k = jax.lax.dynamic_update_slice_in_dim(
        jnp.asarray(stage_k), jrope.apply_rope(jk, jc, js, positions=jpos),
        step, axis=1)
    want_v = jax.lax.dynamic_update_slice_in_dim(jnp.asarray(stage_v), jv,
                                                 step, axis=1)

    tc, ts = (torch.from_numpy(np.array(t)) for t in (jc, js))
    sk, sv = torch.from_numpy(stage_k.copy()), torch.from_numpy(stage_v.copy())
    tpos = torch.from_numpy(pos)
    before = rope.apply_rope.fwd_launches, rope.apply_rope.stage_launches
    if fused:
        q = rope.rope_stage_fused(torch.from_numpy(qkv), tc, ts, tpos, sk,
                                  sv, step)
    else:
        q = rope.rope_stage(torch.from_numpy(np.array(jq)),
                            torch.from_numpy(np.array(jk)),
                            torch.from_numpy(np.array(jv)), tc, ts, tpos,
                            sk, sv, step)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(want_v))
    # The CPU runs the plain version: no kernel was launched.
    assert (rope.apply_rope.fwd_launches,
            rope.apply_rope.stage_launches) == before


def test_rope_stage_refuses_a_bad_step_or_several_tokens():
    q, k = torch.zeros(2, 1, 4, 16), torch.zeros(2, 1, 2, 16)
    sk, sv = torch.zeros(2, 4, 2, 16), torch.zeros(2, 4, 2, 16)
    cos, sin = rope.rope_frequencies(16, 8)
    pos = torch.zeros(2, 1, dtype=torch.int64)
    for bad in (4, -1, True):
        with pytest.raises(ValueError, match="stage_step"):
            rope.rope_stage(q, k, k, cos, sin, pos, sk, sv, bad)
    with pytest.raises(ValueError, match="one token"):
        rope.rope_stage(q.expand(2, 3, 4, 16), k, k, cos, sin, pos, sk, sv,
                        0)
    assert torch.equal(sk, torch.zeros_like(sk))


# ------------------------------------------------------ K4's epilogue


def _jax_tiny(seed, **kw):
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, max_seq_len=64, **kw)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))))
    return jmodel, params


@pytest.mark.parametrize("fused", [False, True])
def test_int8_mlp_at_decode_rows_matches_jax(fused):
    flags = {"fused_gate_up": True} if fused else {}
    jmodel, params = _jax_tiny(11, **flags)
    cfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=64, **flags)
    model = Llama(cfg)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    model.requires_grad_(False)
    _quantize_int8(model, 64)
    mlp = model.layers[0].mlp
    # Jitted: one program, bitwise the engine's eager leaf-by-leaf calls.
    q_tree, s_tree = jax.jit(jax_quantize_int8, static_argnums=1)(params, 64)

    def materialize(q, s):            # the JAX engine's _materialize
        return (q.astype(jnp.bfloat16) * s.astype(jnp.bfloat16)
                if s.size else q)

    @jax.jit
    def jax_mlp(q, s, x):
        p = jax.tree.map(materialize, q, s)
        return JaxMlp(jmodel.cfg).apply(
            {"params": p["params"]["layer_0"]["mlp"]}, x)

    rs = np.random.RandomState(12)
    for rows in (1, 8, DECODE_MAX_ROWS):
        x = rs.randn(rows, 1, cfg.embed_dim).astype(np.float32)
        assert mlp.epilogue_weights(torch.from_numpy(x)) is not None
        got = mlp(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_mlp(q_tree, s_tree, jnp.asarray(x)))
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        if not fused:
            assert np.array_equal(got, mlp.reduce(
                *mlp.products(torch.from_numpy(x))).numpy())
    # Past the decode kernel's rows, the products and K9 (here: plain).
    assert mlp.epilogue_weights(torch.zeros(DECODE_MAX_ROWS + 1, 1,
                                            cfg.embed_dim)) is None


def test_bf16_weights_take_no_epilogue():
    mlp = Llama(LlamaConfig.tiny()).layers[0].mlp
    assert mlp.epilogue_weights(torch.zeros(8, 1, 64)) is None


# ------------------------------------------------------------- engine


def _spied(monkeypatch, name):
    calls = []
    real = getattr(port_llama, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_llama, name, spy)
    return calls


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["unfused", "fused"])
def test_staged_int8_engine_tokens_match_jax(monkeypatch, flags):
    """Two slots, chunk 4 staged (two flushes in each generation), int8
    weights: every decode step's RoPE is the staged mode and its MLP the
    K4 epilogue; greedy tokens equal the JAX engine's."""
    jmodel, params = _jax_tiny(0, **flags)
    params = jax.tree.map(lambda x: x * 8 if x.ndim >= 2 else x, params)
    staged = {"decode_staging": 4}
    kw = dict(param_dtype="", max_batch=2, max_len=64, decode_chunk=4,
              prefill_buckets=(8, 16), quantize="int8",
              quantize_min_size=64)
    cfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=64, **flags,
                           **staged)
    model = Llama(cfg)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    stages = _spied(monkeypatch, "rope_stage_fused" if flags
                    else "rope_stage")
    epilogues = _spied(monkeypatch, "int8_linear_swiglu")
    requests = [([3, 1, 4, 1, 5], 9), (list(range(20, 32)), 7)]

    def serve(engine):
        rids = [engine.submit(p, max_new_tokens=n) for p, n in requests]
        engine.run()
        return [engine.result(r).tokens for r in rids]

    port = ServingEngine(model, ServingConfig(**kw), device="cpu",
                         registry=MetricsRegistry())
    got = serve(port)
    jeng = JaxServingEngine(
        JaxLlama(dataclasses.replace(jmodel.cfg, **staged)), params,
        JaxServingConfig(**kw), registry=JaxRegistry())
    assert got == serve(jeng)
    assert [len(t) for t in got] == [9, 7]
    layers = cfg.num_layers
    steps = port.decode_dispatches * kw["decode_chunk"]
    assert steps > 0 and len(stages) == layers * steps
    # Decode steps run 2 rows, and each prefill here one bucket of 8 or
    # 16 rows: all within the decode kernel's 16.
    assert len(epilogues) == layers * (steps + port.prefill_dispatches)

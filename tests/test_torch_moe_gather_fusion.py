"""The MoE gather deferred into the expert function, on the CPU, against
the plain versions and the JAX package (mixtral-tiny's widths: E = 4, M =
64, F = 128).

- ``ops/moe.py::Gather.materialize`` equals ``gather_rows_reference``
  bitwise.
- ``parallel/moe.py::moe_dispatch(defer_gather=True)`` with
  ``MoeMlp.experts`` (the gather's inputs, ``models/mixtral.py::
  gate_up_swiglu``'s route) gives bitwise the output and aux loss of the
  materialised dispatch with today's expert function (gather, gate and up
  products, K9, down), with int8 and with bf16 expert leaves, capacity
  drops included; ``expert_rows`` is the buffers' row count.
- ``ops/int8_experts.py::int8_experts_swiglu_reference`` (and the
  wrapper on CPU tensors) equals the chain it states bitwise:
  ``gather_rows_reference``, ``int8_experts_reference`` for gate and for
  up, ``swiglu_reference``.
- ``MoeMlp`` with int8 leaves through the dispatch matches the JAX
  dispatch with the JAX engine's int8 expert function (its
  ``_quantize_int8`` and ``_materialize``, then ``MoeMlp.expert_fn``'s
  einsums in bf16, as tests/test_torch_mixtral_int8.py's
  ``test_experts_reference_matches_jax_einsum`` runs them): within 1e-2 x
  max|JAX|, that test's bf16 bound.

The fused kernel runs only on the card: tests/test_torch_cuda.py holds it
bitwise against K13, K15's gate and up launches and K9 there.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.serving.engine import _quantize_int8 as jax_quantize_int8
from kubeflow_tpu_torch.models import MixtralConfig
from kubeflow_tpu_torch.models import mixtral as tmixtral
from kubeflow_tpu_torch.ops import int8_experts as ie
from kubeflow_tpu_torch.ops import moe
from kubeflow_tpu_torch.ops.swiglu import swiglu, swiglu_reference
from kubeflow_tpu_torch.parallel.moe import expert_rows, moe_dispatch
from kubeflow_tpu_torch.serving.engine import _quantize_expert_leaf

torch.set_num_threads(1)

CFG = MixtralConfig.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
E, M, F = CFG.num_experts, CFG.embed_dim, CFG.mlp_dim
LEAVES = ("w_gate", "w_up", "w_down")
# Tokens a dispatch: a decode step's 8 slots and a 32-row prefill, each
# one group; the hot expert drops choices at both.
TOKENS = [8, 32]


def _inputs(T, seed):
    """x [T, M] bf16 and router logits [T, E] f32 with a hot expert 0."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((T, M)).astype(np.float32)
    logits = rs.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += 2.0
    return torch.from_numpy(x).bfloat16(), torch.from_numpy(logits)


@pytest.fixture(scope="module")
def leaves():
    """The expert leaves in the JAX layout ([E, M, F], [E, F, M]), bf16
    N(0, 0.02), as numpy f32 of bf16 values."""
    rs = np.random.RandomState(21)
    shapes = {"w_gate": (E, M, F), "w_up": (E, M, F), "w_down": (E, F, M)}
    return {n: np.asarray(torch.from_numpy(
        rs.standard_normal(s).astype(np.float32) * 0.02).bfloat16().float())
        for n, s in shapes.items()}


def _mlp(leaves, int8):
    """A port ``MoeMlp`` holding ``leaves``, each an ``Int8Experts`` as the
    engine quantizes it (``int8``) or a bf16 parameter."""
    mlp = tmixtral.MoeMlp(CFG)
    mlp.requires_grad_(False)
    for n in LEAVES:
        w = torch.from_numpy(leaves[n]).bfloat16()
        if int8:
            delattr(mlp, n)
            setattr(mlp, n, tmixtral.Int8Experts(*_quantize_expert_leaf(w),
                                                 CFG))
        else:
            getattr(mlp, n).copy_(w)
    return mlp


def _chain(mlp):
    """The materialised dispatch's expert function: gate and up, K9, down
    on the gathered buffers [E, C, M]."""
    def fn(e_in):
        gate = tmixtral._expert_product(e_in, mlp.w_gate)
        up = tmixtral._expert_product(e_in, mlp.w_up)
        return tmixtral._expert_product(swiglu(gate, up), mlp.w_down)
    return fn


@pytest.mark.parametrize("T", TOKENS)
def test_gather_materialize_is_the_plain_gather_bitwise(T):
    x, logits = _inputs(T, T)
    # Capacity T leaves empty slots (token 0's row times 0).
    r = moe.route(logits, 1, T, torch.bfloat16)
    assert int((r.slot_valid == 0).sum()) > 0
    g = moe.Gather(x, r.slot_tok, r.slot_valid)
    assert torch.equal(g.materialize(), moe.gather_rows_reference(
        x, r.slot_tok, r.slot_valid))


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("T", TOKENS)
def test_deferred_gather_dispatch_equals_materialised_bitwise(leaves, T,
                                                              int8):
    mlp = _mlp(leaves, int8)
    x, logits = _inputs(T, 100 + T)
    want, want_aux = moe_dispatch(x, logits, _chain(mlp), mlp.gate)
    shapes = []

    def experts(g, shape):
        shapes.append(shape)
        return mlp.experts(g, shape)

    got, aux = moe_dispatch(x, logits, experts, mlp.gate, defer_gather=True)
    assert shapes == [(E, expert_rows(T, mlp.gate), M)]
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    deferred, _ = moe_dispatch(x, logits, mlp.experts, mlp.gate,
                               defer=True, defer_gather=True)
    assert torch.equal(deferred.materialize(), want)
    # On the CPU no route is the fused launch.
    assert not tmixtral.fused_route(mlp.w_gate, mlp.w_up, 4, 8)


@pytest.mark.parametrize("rows", [1, 4, 13, 16])
def test_fused_reference_is_its_chain_bitwise(leaves, rows):
    mlp = _mlp(leaves, True)
    T = 8
    x, logits = _inputs(T, rows)
    r = moe.route(logits, 1, rows, torch.bfloat16)
    args = (x, r.slot_tok, r.slot_valid, mlp.w_gate.weight,
            mlp.w_gate.scale, mlp.w_up.weight, mlp.w_up.scale, rows)
    x_e = moe.gather_rows_reference(x, r.slot_tok, r.slot_valid).view(
        E, rows, M)
    want = swiglu_reference(
        ie.int8_experts_reference(x_e, mlp.w_gate.weight, mlp.w_gate.scale),
        ie.int8_experts_reference(x_e, mlp.w_up.weight, mlp.w_up.scale))
    got = ie.int8_experts_swiglu_reference(*args)
    assert got.shape == (E, rows, F) and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    before = ie.int8_experts.launches, ie.int8_experts.swiglu_launches
    assert torch.equal(ie.int8_experts_swiglu(*args), want)
    assert (ie.int8_experts.launches,
            ie.int8_experts.swiglu_launches) == before   # no launch on CPU


def _jax_int8_expert_fn(leaves):
    """The JAX engine's int8 expert function: the leaves quantized by its
    ``_quantize_int8`` and dequantized inside the jitted step by its
    ``_materialize`` (bf16), then ``MoeMlp.expert_fn``'s einsums."""
    params = {"moe": {n: jnp.asarray(leaves[n], jnp.bfloat16)
                      for n in LEAVES}}
    q, scales = jax_quantize_int8(params, 4096)
    eng = types.SimpleNamespace(
        _scales=scales, _qflags=jax.tree.map(lambda s: bool(s.size > 0),
                                             scales),
        cfg=types.SimpleNamespace(param_dtype="bfloat16"))
    assert all(jax.tree.leaves(eng._qflags))

    def expert_fn(e_in):
        w = JaxServingEngine._materialize(eng, q)["moe"]
        gate = jnp.einsum("ecm,emh->ech", e_in, w["w_gate"].astype(e_in.dtype),
                          preferred_element_type=jnp.float32
                          ).astype(e_in.dtype)
        up = jnp.einsum("ecm,emh->ech", e_in, w["w_up"].astype(e_in.dtype),
                        preferred_element_type=jnp.float32).astype(e_in.dtype)
        h = nn.silu(gate) * up
        return jnp.einsum("ech,ehm->ecm", h, w["w_down"].astype(h.dtype),
                          preferred_element_type=jnp.float32
                          ).astype(e_in.dtype)
    return expert_fn


def test_int8_moe_matches_jax_engine_expert_function(leaves):
    mlp = _mlp(leaves, True)
    expert_fn = _jax_int8_expert_fn(leaves)
    jcfg = jmoe.Top2GateConfig(num_experts=E,
                               capacity_factor=CFG.capacity_factor)

    @jax.jit
    def dispatch(x, logits):
        return jmoe.moe_dispatch(x, logits, expert_fn, jcfg)

    for T in TOKENS:
        x, logits = _inputs(T, 200 + T)
        got, aux = moe_dispatch(x, logits, mlp.experts, mlp.gate,
                                defer_gather=True)
        want, want_aux = dispatch(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(logits.numpy()))
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max(),
                                   err_msg=f"T {T}")
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

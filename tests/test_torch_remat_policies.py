"""The port's seven remat policies (``LlamaConfig.remat_policy``) on the CPU.

For each policy, with and without the fused projections:

- the loss and every parameter gradient are bitwise those of the same
  model with ``remat=False`` (f32: a policy changes what is saved and
  replayed, never the arithmetic);
- with both fused flags, the gradients are within 1e-5 of the JAX model's
  under the same policy (f32; 1e-4 relative: a 2-layer model summed in
  another order);
- per layer, the activations saved between forward and backward, counted
  with ``torch.autograd.graph.saved_tensors_hooks``, are exactly the
  layer input and the tensors the JAX policy names
  (kubeflow_tpu/models/llama.py::_remat_policy), no more: the tables and
  positions of RoPE are not activations and are left out.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.train import losses as jlosses
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.models.llama import REMAT_POLICIES
from kubeflow_tpu_torch.train import losses as tlosses

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

TOKENS = np.random.RandomState(6).randint(0, 256, (2, 17))
B, S = 2, 16
# llama-tiny: E 64, H 4, Hkv 2 (G 2), D 16, F 128.
SHAPES = {
    "x": (B, S, 64), "h": (B, S, 64),
    "q": (B, S, 4, 16), "out": (B, S, 4, 16), "k": (B, S, 2, 16),
    "v": (B, S, 2, 16), "lse": (B, 4, S),
    "gate": (B, S, 128), "up": (B, S, 128), "gu": (B, S, 2, 128),
    "qkv": (B, S, 2, 4, 16),
}
#: What each policy saves a layer besides its input: the JAX policy's
#: names ("qkv": q, k, v after RoPE; "attn_out": the attention output,
#: which is also K1's o; "attn_resid": o and lse; "mlp_gate", "mlp_up";
#: "dots": the projections' outputs the backward needs, q/k/v before RoPE,
#: o_proj's h, gate and up).
SAVES = {
    "full": (),
    "qkv_attn": ("q", "k", "v", "out"),
    "qkv_attn_lse": ("q", "k", "v", "out", "lse"),
    "minimal": ("q", "k", "v", "out", "lse", "gate", "up"),
    "attn_only": ("out",),
    "mlp_only": ("gate", "up"),
    "dots": ("q", "k", "v", "h", "gate", "up"),
}


def _fused_names(names, fused):
    if not fused:
        return names
    out = [n for n in names if n not in ("gate", "up")]
    if "gate" in names:
        out.append("gu")
    return out


def _expected(policy, fused):
    names = ["x", *SAVES[policy]]
    if policy == "dots" and fused:             # the fused product itself
        names = [n for n in names if n not in ("q", "k", "v")] + ["qkv"]
    return collections.Counter(SHAPES[n] for n in _fused_names(names, fused))


def _cfg(policy, fused, **kw):
    return LlamaConfig.tiny(dtype=torch.float32, fused_qkv=fused,
                            fused_gate_up=fused, **kw,
                            **(dict(remat=True, remat_policy=policy)
                               if policy else {}))


def _loss_and_grads(model):
    logits = model(torch.from_numpy(TOKENS[:, :-1]))
    loss, _ = tlosses.cross_entropy_loss(
        logits, torch.from_numpy(TOKENS[:, 1:]), z_loss_weight=1e-4)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(7)
    out = {}
    for fused in (False, True):
        model = Llama(_cfg(None, fused))
        model.init_weights(gen)
        out[fused] = (model.state_dict(), _loss_and_grads(model))
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_policy_is_bitwise_no_remat(weights, policy, fused):
    sd, (want_loss, want_grads) = weights[fused]
    model = Llama(_cfg(policy, fused))
    model.load_state_dict(sd)
    loss, grads = _loss_and_grads(model)
    assert torch.equal(loss, want_loss)
    for (name, _), g, w in zip(model.named_parameters(), grads, want_grads):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_policy_saves_exactly_its_names(policy, fused):
    model = Llama(_cfg(policy, fused))
    model.init_weights(torch.Generator().manual_seed(8))
    layer = model.layers[0]
    cos, sin = model.rope_tables(torch.device("cpu"))
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(9),
                    requires_grad=True)
    positions = torch.arange(S).expand(B, S)
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        out = layer.forward_remat(x, positions, cos, sin, policy)
    params = {p.data_ptr() for p in model.parameters()}
    saved = {}
    for t in packed:
        if (t.is_floating_point() and t.data_ptr() not in params
                and t.data_ptr() not in (cos.data_ptr(), sin.data_ptr())):
            saved[(t.data_ptr(), tuple(t.shape))] = tuple(t.shape)
    assert collections.Counter(saved.values()) == _expected(policy, fused)
    assert (x.data_ptr(), tuple(x.shape)) in saved
    out.sum().backward()                   # the replays run and agree
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.fixture(scope="module")
def jax_fused():
    jmodels = {}
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, fused_qkv=True,
                               fused_gate_up=True)
    params = jax.device_get(nn.meta.unbox(JaxLlama(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    for policy in REMAT_POLICIES:
        jmodels[policy] = JaxLlama(JaxLlamaConfig.tiny(
            dtype=jnp.float32, fused_qkv=True, fused_gate_up=True,
            remat=True, remat_policy=policy))
    return jmodels, params


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_fused_policy_grads_match_jax(jax_fused, policy):
    jmodels, params = jax_fused
    jmodel = jmodels[policy]
    inputs, labels = TOKENS[:, :-1], TOKENS[:, 1:]

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(inputs))
        return jlosses.cross_entropy_loss(logits, jnp.asarray(labels),
                                          z_loss_weight=1e-4)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    cfg = _cfg(policy, True)
    model = Llama(cfg)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    loss, grads = _loss_and_grads(model)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6)
    want = llama_params_from_jax(jax.device_get(jgrads), cfg)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)

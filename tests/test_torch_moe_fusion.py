"""The MoE routing's group-form order and the combine deferred into the
residual add + RMSNorm, on the CPU, against the plain versions and the JAX
package.

- ``ops/moe.py::aux_fold_reference`` (the order K12's group form splits
  the aux loss's fold by halves over its blocks) and the kernel's whole
  layout written out here (lanes, rounds in bit-reversed order on a stack,
  warps, blocks) equal ``_fold_sum`` bitwise in f32.
- ``ops/moe.py::combine_add_rms_norm`` given a deferred combine
  (``ops/moe.py::Combine``) equals ``combine_rows_reference`` then
  ``add_rms_norm_reference`` bitwise, dropped choices (the trash row)
  included.
- mixtral-tiny through the deferred path (``MixtralLayer.close``) gives
  bitwise the logits, hidden states and served tokens of the
  materialised path (the generic ``DecoderLayer.close``), and the JAX
  Mixtral's f32 logits within atol 1e-4 (tests/test_torch_mixtral.py's
  bound); ``DecoderLayer.forward`` on a Mixtral layer returns a tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import Mixtral as JaxMixtral
from kubeflow_tpu.models import MixtralConfig as JaxMixtralConfig
from kubeflow_tpu_torch.models import Mixtral, MixtralConfig
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import mixtral as tmixtral
from kubeflow_tpu_torch.models.convert import mixtral_params_from_jax
from kubeflow_tpu_torch.ops import moe, norms
from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

torch.set_num_threads(1)

FOLD_TOKENS = [1, 7, 8, 33, 100, 4096]


def _gates(g, E=8, seed=0):
    """A softmax over E experts for g tokens, f32 (what the fold sums)."""
    x = np.random.RandomState(seed).randn(g, E).astype(np.float32) * 2
    return torch.softmax(torch.from_numpy(x), dim=-1)


def _pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


@pytest.mark.parametrize("g", FOLD_TOKENS)
def test_group_form_aux_order_is_the_fold_bitwise(g):
    x = _gates(g, seed=g)
    want = moe._fold_sum(x, 0)
    P = _pow2(g)
    nb = 1
    while nb <= P:
        assert torch.equal(moe.aux_fold_reference(x, nb), want), nb
        nb *= 2
    with pytest.raises(ValueError, match="power of two"):
        moe.aux_fold_reference(x, 3)


def _kernel_order(x, nb, warps):
    """K12's group-form fold of x [g, E] over nb blocks of ``warps`` warps,
    step for step: token t = low + Lw lane with Lw = P / 32; each round an
    xor fold over the 32 lanes; the warp's rounds r (low = b + nb (w + Wa
    r)) taken in bit-reversed order onto a stack of partial sums; the
    block's Wa warps folded by halves, then the nb blocks'."""
    g, E = x.shape
    P = max(64, _pow2(g))
    Lw = P // 32
    Wa = min(warps, Lw // nb)
    R = Lw // (nb * Wa)
    logR = R.bit_length() - 1
    xp = torch.cat([x, x.new_zeros(P - g, E)])

    def brev(k):
        return int(f"{k:0{logR}b}"[::-1], 2) if logR else 0

    blocks = []
    for b in range(nb):
        parts = []
        for w in range(Wa):
            stack = {}
            for k in range(R):
                low = b + nb * (w + Wa * brev(k))
                v = xp[low + Lw * torch.arange(32)]        # [32, E]
                h = 16
                while h >= 1:                              # xor fold
                    v = v + v[torch.arange(32) ^ h]
                    h //= 2
                v, level = v[0], 0
                while (k >> level) & 1:
                    v = stack.pop(level) + v
                    level += 1
                stack[level] = v
            parts.append(stack[logR])
        blocks.append(moe._fold_sum(torch.stack(parts), 0))
    return moe._fold_sum(torch.stack(blocks), 0)


@pytest.mark.parametrize("g", [33, 100, 1000, 4096])
def test_group_form_kernel_layout_is_the_fold_bitwise(g):
    x = _gates(g, seed=7 + g)
    want = moe._fold_sum(x, 0)
    P = max(64, _pow2(g))
    for nb in (1, 2, 4, 8):
        if nb > P // 32:
            continue
        for warps in (32, 16, 8):            # the block sizes by E
            assert torch.equal(_kernel_order(x, nb, warps), want), (nb,
                                                                    warps)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_add_rms_norm_takes_a_deferred_combine_bitwise(dtype):
    rs = np.random.RandomState(3)
    T, E, M, C = 24, 4, 64, 3                    # capacity drops choices
    logits = torch.from_numpy(rs.randn(T, E).astype(np.float32))
    logits[:, 0] += 2.0
    r = moe.route_reference(logits, 1, C, dtype)
    S = E * C
    assert int((r.dest1 == S).sum() + (r.dest2 == S).sum()) > 0
    y = torch.from_numpy(rs.randn(S, M).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rs.randn(2, T // 2, M).astype(np.float32)).to(dtype)
    w = torch.from_numpy(1 + 0.1 * rs.randn(M).astype(np.float32)).to(dtype)
    c = moe.Combine(y, r.g1, r.g2, r.dest1, r.dest2)
    got = moe.combine_add_rms_norm(x, c, w, eps=1e-6)
    h = moe.combine_rows_reference(y, r.g1, r.g2, r.dest1, r.dest2)
    want_r, want_y, _ = norms.add_rms_norm_reference(x, h.view(x.shape), w,
                                                     eps=1e-6)
    assert torch.equal(got[0], want_r) and torch.equal(got[1], want_y)
    assert torch.equal(c.materialize(), h)


@pytest.fixture(scope="module")
def tiny():
    """mixtral-tiny in f32 on JAX-initialised weights, with each router
    leaning on expert 0 so that capacity drops choices, and the JAX
    model and params."""
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32, capacity_factor=1.0)
    params = jax.device_get(nn.meta.unbox(jax.jit(JaxMixtral(jcfg).init)(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    params = {"params": params["params"]}
    for i in range(jcfg.num_layers):
        router = params["params"][f"layer_{i}"]["moe"]["router"]
        router["kernel"] = np.array(router["kernel"])
        router["kernel"][:, 0] += 0.5
    tcfg = MixtralConfig.tiny(dtype=torch.float32, capacity_factor=1.0)
    return JaxMixtral(jcfg), params, tcfg, mixtral_params_from_jax(params,
                                                                  tcfg)


def _model(tiny):
    _, _, tcfg, sd = tiny
    model = Mixtral(tcfg)
    model.load_state_dict(sd)
    return model


class _Deferred:
    """Counts the add + norms that take a deferred combine."""

    def __init__(self, monkeypatch):
        self.n = 0
        add = tmixtral.combine_add_rms_norm

        def counting(x, c, weight, *, eps):
            assert isinstance(c, moe.Combine)
            self.n += 1
            return add(x, c, weight, eps=eps)

        monkeypatch.setattr(tmixtral, "combine_add_rms_norm", counting)


def _materialise(monkeypatch):
    """The Mixtral layers close as any decoder layer: the MoE output as a
    tensor, then the add + norm."""
    monkeypatch.setattr(tmixtral.MixtralLayer, "close",
                        tllama.DecoderLayer.close)


def test_deferred_combine_is_bitwise_the_materialised_path(tiny,
                                                           monkeypatch):
    jmodel, params, tcfg, _ = tiny
    model = _model(tiny)
    tokens = np.random.RandomState(5).randint(0, tcfg.vocab_size, (2, 12))
    deferred = _Deferred(monkeypatch)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
        hidden = model(torch.from_numpy(tokens), return_hidden=True)
    assert deferred.n == 2 * tcfg.num_layers
    _materialise(monkeypatch)
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(tokens)), logits)
        assert torch.equal(model(torch.from_numpy(tokens),
                                 return_hidden=True), hidden)
    assert deferred.n == 2 * tcfg.num_layers
    want, _ = jax.jit(lambda p, t: jmodel.apply(p, t, mutable=["losses"]))(
        params, jnp.asarray(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _serve(model):
    engine = ServingEngine(model, ServingConfig(
        param_dtype="", max_batch=4, max_len=64, decode_chunk=4,
        prefill_buckets=(8, 16)), device="cpu", registry=MetricsRegistry())
    prompts = [([3, 1, 4, 1, 5], 6), ([9, 2, 6], 5), ([5, 3, 5, 8, 9, 7], 6)]
    rids = [engine.submit(p, max_new_tokens=n) for p, n in prompts]
    engine.run()
    return [engine.result(r).tokens for r in rids]


def test_decoding_through_the_deferred_combine_is_bitwise(tiny,
                                                          monkeypatch):
    deferred = _Deferred(monkeypatch)
    got = _serve(_model(tiny))
    assert deferred.n > 0
    _materialise(monkeypatch)
    before = deferred.n
    assert _serve(_model(tiny)) == got
    assert deferred.n == before
    assert [len(t) for t in got] == [6, 5, 6]


def test_decoder_layer_forward_on_a_mixtral_layer_returns_a_tensor(tiny):
    model = _model(tiny)
    layer = model.layers[0]
    x = torch.from_numpy(np.random.RandomState(9).randn(
        2, 6, model.cfg.embed_dim).astype(np.float32))
    positions = torch.arange(6).expand(2, 6)
    cos, sin = model.rope_tables(x.device)
    norm = model.final_norm
    with torch.no_grad():
        out = layer(x, positions, cos, sin)
        r, n = layer.attend(x, layer.input_norm(x), positions, cos, sin)
        d, c = layer.mlp(n), layer.mlp(n, defer=True)
        closed = layer.close(r, n, norm)
        want = norm.add(r, d)
    assert isinstance(out, torch.Tensor) and out.shape == x.shape
    assert isinstance(c, moe.Combine) and isinstance(d, torch.Tensor)
    assert torch.equal(out, r + d)
    assert torch.equal(c.materialize().view(x.shape), d)
    assert torch.equal(closed[0], want[0]) and torch.equal(closed[1],
                                                           want[1])

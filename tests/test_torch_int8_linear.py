"""The port's int8 weights against the JAX engine's, on llama-tiny.

- ``serving/engine.py::_quantize_int8`` of the port against the JAX
  ``_quantize_int8`` (``quantize_min_size=64``): the same leaves quantized,
  int8 values and bf16 scales bitwise, o_proj's per-(head dim, output row)
  scale included; ``models/convert.py::quantized_params_from_jax`` of the
  JAX engine's trees gives the same bytes.
- ``ops/int8_linear.py::int8_linear_reference`` against the JAX engine's
  ``_materialize`` and flax's DenseGeneral, at each projection's shape: the
  dequantized bf16 weights bitwise; the f32 products, jitted as the
  engine's steps are (XLA keeps the dequantized kernel in f32 there),
  within atol 1e-5 (summed in another order).
- ``int8_linear_group`` (one launch for products of the same x on the
  card) on the CPU: each output bitwise the separate product's; the
  model's grouped q/k/v and gate/up bitwise its projections one by one;
  the launches a forward pass makes, from the groups the model forms.

The kernel (K4) runs only on the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

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
from kubeflow_tpu.serving.engine import _quantize_int8 as jax_quantize_int8
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import (
    llama_params_from_jax,
    quantized_params_from_jax,
)
from kubeflow_tpu_torch.models.layout import to_scanned_layout
from kubeflow_tpu_torch.models import llama as port_llama
from kubeflow_tpu_torch.models.llama import Int8Dense, int8_launches_per_pass
from kubeflow_tpu_torch.ops.int8_linear import (
    dequantize_int8,
    int8_linear,
    int8_linear_group,
    int8_linear_reference,
)
from kubeflow_tpu_torch.ops.swiglu import swiglu
from kubeflow_tpu_torch.serving.engine import _quantize_int8

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

MIN_SIZE = 64


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, max_seq_len=64)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(3), jnp.ones((1, 8), jnp.int32))))
    tcfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=64)
    return jmodel, params, tcfg


def _port_quantized(tiny, min_size=MIN_SIZE):
    _, params, tcfg = tiny
    model = Llama(tcfg)
    model.load_state_dict(llama_params_from_jax(params, tcfg))
    model.requires_grad_(False)
    names = _quantize_int8(model, min_size)
    return model, names


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_quantize_matches_jax_bitwise(tiny):
    _, params, tcfg = tiny
    model, names = _port_quantized(tiny)
    q_tree, s_tree = jax_quantize_int8(params, MIN_SIZE)
    want = quantized_params_from_jax(jax.device_get(q_tree),
                                     jax.device_get(s_tree), tcfg)
    int8 = {n for n, m in model.named_modules() if isinstance(m, Int8Dense)}
    assert {n.rsplit(".", 1)[0] for n in names} == int8
    assert int8 == {k[:-len(".scale")] for k in want if k.endswith(".scale")}
    assert len(int8) == 7 * tcfg.num_layers + 1       # lm_head included
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        assert _same_bits(got[key], w), key
    o = model.layers[0].attn.o_proj
    assert o.scale.shape == (tcfg.embed_dim, tcfg.head_dim)
    assert model.layers[0].attn.q_proj.scale.shape == (
        tcfg.num_heads * tcfg.head_dim, 1)
    # The embedding and the norms stay as they were.
    plain = llama_params_from_jax(params, tcfg)
    for key in ("embed", "final_norm.weight", "layers.1.input_norm.weight"):
        assert torch.equal(got[key], plain[key])
        assert got[key].dtype == torch.float32


def test_o_proj_scale_is_per_head_dim_not_per_row(tiny):
    """A per-row scale of o_proj is another function: its int8 values
    differ from the JAX engine's."""
    _, params, tcfg = tiny
    model, _ = _port_quantized(tiny)
    w = torch.from_numpy(np.array(
        params["params"]["layer_0"]["attn"]["o_proj"]["kernel"])).reshape(
            -1, tcfg.embed_dim).T
    row = torch.round(w / (w.abs().amax(1, keepdim=True) / 127.0))
    assert not torch.equal(row.to(torch.int8),
                           model.layers[0].attn.o_proj.weight)


def test_default_min_size_quantizes_nothing_tiny(tiny):
    _, params, _ = tiny
    _, names = _port_quantized(tiny, min_size=65536)
    _, s_tree = jax_quantize_int8(params, 65536)
    assert names == []
    assert all(s.size == 0 for s in jax.tree.leaves(s_tree))


def test_stacked_quantized_tree_refused(tiny):
    _, params, tcfg = tiny
    stacked = {"params": to_scanned_layout(params["params"],
                                           tcfg.num_layers)}
    q_tree, s_tree = jax_quantize_int8(stacked, MIN_SIZE, stacked_layers=True)
    with pytest.raises(ValueError, match="stacked"):
        quantized_params_from_jax(jax.device_get(q_tree),
                                  jax.device_get(s_tree), tcfg)


def _jax_engine(tiny):
    jmodel, params, _ = tiny
    return JaxServingEngine(
        jmodel, params,
        JaxServingConfig(max_batch=1, max_len=64, quantize="int8",
                         quantize_min_size=MIN_SIZE, param_dtype=""),
        registry=JaxRegistry())


def test_reference_matches_materialize_and_dense(tiny):
    _, _, tcfg = tiny
    eng = _jax_engine(tiny)
    want = quantized_params_from_jax(jax.device_get(eng.params),
                                     jax.device_get(eng._scales), tcfg)
    deq = jax.device_get(eng._materialize(eng.params))["params"]
    model, _ = _port_quantized(tiny)
    for key, w in want.items():              # the engine's trees, converted
        assert _same_bits(model.state_dict()[key], w), key
    # The dequantized weights bitwise, in bf16 as _materialize makes them.
    plain = llama_params_from_jax({"params": deq}, tcfg)
    for name, mod in model.named_modules():
        if isinstance(mod, Int8Dense):
            w = plain[f"{name}.weight"]
            assert w.dtype == torch.bfloat16
            assert _same_bits(dequantize_int8(mod.weight, mod.scale), w), name
    E, H, Hkv, Dh, M = (tcfg.embed_dim, tcfg.num_heads, tcfg.num_kv_heads,
                        tcfg.head_dim, tcfg.mlp_dim)
    rs = np.random.RandomState(0)
    cases = {   # name: (JAX path, features, axis, input width)
        "attn.q_proj": (("layer_0", "attn", "q_proj"), (H, Dh), -1, E),
        "attn.k_proj": (("layer_0", "attn", "k_proj"), (Hkv, Dh), -1, E),
        "attn.v_proj": (("layer_0", "attn", "v_proj"), (Hkv, Dh), -1, E),
        "attn.o_proj": (("layer_0", "attn", "o_proj"), E, (-2, -1), H * Dh),
        "mlp.gate_proj": (("layer_0", "mlp", "gate_proj"), M, -1, E),
        "mlp.up_proj": (("layer_0", "mlp", "up_proj"), M, -1, E),
        "mlp.down_proj": (("layer_0", "mlp", "down_proj"), E, -1, M),
        "lm_head": (("lm_head",), tcfg.vocab_size, -1, E),
    }
    for name, (path, features, axis, width) in cases.items():
        dense = nn.DenseGeneral(features=features, axis=axis, use_bias=False,
                                dtype=jnp.float32)

        @jax.jit
        def product(params, x, path=path, dense=dense):
            # The engine's step: _materialize, then the DenseGeneral.
            tree = eng._materialize(params)["params"]
            for key in path:
                tree = tree[key]
            return dense.apply({"params": tree}, x)

        x = rs.standard_normal((2, 5, width)).astype(np.float32)
        xin = x.reshape(2, 5, H, Dh) if name == "attn.o_proj" else x
        ref = np.asarray(product(eng.params, jnp.asarray(xin)))
        mod = model.get_submodule(name if name == "lm_head"
                                  else f"layers.0.{name}")
        got = int8_linear_reference(torch.from_numpy(x), mod.weight,
                                    mod.scale, out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), ref.reshape(2, 5, -1),
                                   atol=1e-5, rtol=0, err_msg=name)
        assert torch.equal(mod(torch.from_numpy(x)), got)


def test_cpu_call_takes_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (48, 64), generator=g, dtype=torch.int8)
    scale = torch.rand(48, 16, generator=g).to(torch.bfloat16)
    x = torch.randn(3, 4, 64, generator=g)
    before = int8_linear.launches
    got = int8_linear(x, q, scale)
    assert int8_linear.launches == before              # no kernel here
    assert got.shape == (3, 4, 48) and got.dtype == torch.float32
    # Each weight rounded once to the product's dtype: bf16 is the bf16
    # product of bf16 q and scale; f32 keeps the exact product.
    want_w = (q.float().view(48, 4, 16) * scale.float().view(48, 1, 16))
    w = dequantize_int8(q, scale)
    assert torch.equal(w, (q.bfloat16().view(48, 4, 16)
                           * scale.view(48, 1, 16)).view(48, 64))
    assert torch.equal(dequantize_int8(q, scale, torch.float32),
                       want_w.view(48, 64))
    torch.testing.assert_close(got, x @ want_w.view(48, 64).T, atol=1e-5,
                               rtol=0)
    bf = int8_linear(x.bfloat16(), q, scale, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, x.bfloat16() @ w.T)
    with pytest.raises(ValueError, match="cuda .* or cpu"):
        int8_linear(x.to("meta"), q, scale)


@pytest.mark.parametrize("period,dtype", [(1, torch.bfloat16),
                                          (16, torch.bfloat16),
                                          (1, torch.float32)])
def test_group_equals_separate_products_bitwise(period, dtype):
    g = torch.Generator().manual_seed(1)
    pairs = [(torch.randint(-127, 128, (n, 64), generator=g,
                            dtype=torch.int8),
              torch.rand(n, period, generator=g).to(torch.bfloat16))
             for n in (80, 16, 32)]
    x = torch.randn(2, 3, 64, generator=g).to(dtype)
    before = int8_linear.launches
    got = int8_linear_group(x, pairs, out_dtype=dtype)
    assert int8_linear.launches == before              # no kernel here
    assert len(got) == 3
    for y, (q, scale) in zip(got, pairs):
        assert y.shape == (2, 3, q.shape[0]) and y.dtype == dtype
        assert torch.equal(y, int8_linear_reference(x, q, scale,
                                                    out_dtype=dtype))
    with pytest.raises(ValueError, match="1 to 3"):
        int8_linear_group(x, pairs + pairs[:1])
    with pytest.raises(ValueError, match="cuda .* or cpu"):
        int8_linear_group(x.to("meta"), pairs)


def test_grouped_projections_equal_ungrouped(tiny, monkeypatch):
    """Attention.project's q/k/v and Mlp.forward's gate/up through one
    grouped product give the bits of the projections called one by one;
    so do the model's logits."""
    model, _ = _port_quantized(tiny)
    cfg = model.cfg
    layer = model.layers[0]
    assert port_llama.int8_group(layer.attn.q_proj, layer.attn.k_proj,
                                 layer.attn.v_proj)
    assert port_llama.int8_group(layer.mlp.gate_proj, layer.mlp.up_proj)
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (2, 5, cfg.embed_dim)).astype(np.float32))
    with torch.no_grad():
        gate, up = (layer.mlp.gate_proj(x), layer.mlp.up_proj(x))
        want = layer.mlp.down_proj(swiglu(gate, up))
        assert torch.equal(layer.mlp(x), want)
        positions = torch.arange(5).expand(2, 5)
        cos, sin = model.rope_tables(x.device)
        grouped = layer.attn.project(x, positions, cos, sin)
        tokens = torch.from_numpy(np.random.RandomState(3).randint(
            0, cfg.vocab_size, (2, 7)))
        logits = model(tokens, attn_impl="full")
        monkeypatch.setattr(port_llama, "int8_group", lambda *p: False)
        apart = layer.attn.project(x, positions, cos, sin)
        assert all(torch.equal(a, b) for a, b in zip(grouped, apart))
        assert torch.equal(model(tokens, attn_impl="full"), logits)
        assert torch.equal(layer.mlp(x), want)


@pytest.mark.parametrize("min_size,per_layer", [
    (MIN_SIZE, 4),       # every projection: q/k/v, o, gate/up, down
    (4096, 4),           # k/v stay Dense: q, o, gate/up, down
    (8192, 2),           # gate/up and down only
])
def test_int8_launches_per_pass_follow_the_groups(tiny, min_size, per_layer):
    model, names = _port_quantized(tiny, min_size)
    layers = model.cfg.num_layers
    assert int8_launches_per_pass(model) == per_layer * layers + 1
    attn = model.layers[0].attn
    assert port_llama.int8_group(attn.q_proj, attn.k_proj, attn.v_proj) == (
        min_size == MIN_SIZE)
    # The plain model runs no K4 at all.
    plain = Llama(model.cfg)
    assert int8_launches_per_pass(plain) == 0

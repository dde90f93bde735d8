"""The port's ViT and its image training against the JAX package's, on the
CPU: vit-tiny's forward from converted JAX params, two adamw steps of
``Trainer(task="image")`` against the JAX ``Trainer``, dropout from a
generator, and the raises.

The params are the port's initialisers from seed 0, the head given
weight, handed to both sides as numpy (the JAX model's init would compile
for seconds). Tolerances: f32 logits 1e-5 x max |JAX|; bf16 logits 2e-2 x
max |JAX| (XLA's excess precision off, so each bf16 op rounds as the
port's do); loss, grad_norm and accuracy 1e-5 relative; parameters after
two adamw steps 1e-5 x max |p| a tensor plus 1e-3 x lr (adam divides each
gradient entry by its own RMS, so a small entry's relative f32 error moves
an update of size up to lr), all but the key biases: a key bias adds the
same q . b to every logit of a query's row, which the softmax removes, so
its gradient is 0 in exact arithmetic and adam turns each side's rounding
noise into an update of +-lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubeflow_tpu.models.vit import ViT as JaxViT
from kubeflow_tpu.models.vit import ViTConfig as JaxViTConfig
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu.train.trainer import TrainState as JaxTrainState
from kubeflow_tpu_torch.models import get_model
from kubeflow_tpu_torch.models.convert import (
    vit_params_from_jax,
    vit_params_to_jax,
)
from kubeflow_tpu_torch.models.vit import ViT, ViTConfig, layer_norm_calls
from kubeflow_tpu_torch.ops.gelu import bias_gelu
from kubeflow_tpu_torch.ops.layer_norm import layer_norm
from kubeflow_tpu_torch.train.data import SyntheticImageConfig, synthetic_images
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

IMAGE = dict(batch_size=4, image_size=32, num_classes=10, seed=0)
#: vit-tiny with one encoder block: every op of the model, half the JAX
#: step's compile.
MODEL_KW = dict(num_layers=1)
TRAIN_KW = dict(task="image", learning_rate=1e-2, warmup_steps=1,
                total_steps=10)


def _batches(n):
    stream = synthetic_images(SyntheticImageConfig(**IMAGE))
    return [next(stream) for _ in range(n)]


@pytest.fixture(scope="module")
def params():
    """vit-tiny's params as a JAX tree (numpy, f32)."""
    model = ViT(ViTConfig.tiny(dtype=torch.float32, **MODEL_KW))
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.weight.copy_(torch.from_numpy(
            np.random.RandomState(1).randn(*model.head.weight.shape).astype(
                np.float32) * 0.1))
    return vit_params_to_jax(model.state_dict(), model.cfg)["params"]


def _port(params, dtype=torch.float32, **kw) -> ViT:
    model = ViT(ViTConfig.tiny(dtype=dtype, **MODEL_KW, **kw))
    model.load_state_dict(vit_params_from_jax(params))
    return model


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_forward_matches_jax(params, dtype, tol):
    jmodel = JaxViT(JaxViTConfig.tiny(dtype=getattr(jnp, dtype),
                                      **MODEL_KW))
    images = jnp.asarray(_batches(1)[0]["inputs"])
    jy = np.asarray(jax.jit(jmodel.apply).lower(
        {"params": params}, images).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        {"params": params}, images))
    model = _port(params, getattr(torch, dtype))
    with torch.no_grad():
        y = model(torch.from_numpy(np.array(images)))
    assert y.dtype == torch.float32 and y.shape == (4, 10)
    assert np.abs(y.numpy() - jy).max() <= tol * np.abs(jy).max()


def test_convert_round_trip(params):
    back = vit_params_to_jax(_port(params).state_dict(),
                             ViTConfig.tiny(**MODEL_KW))["params"]
    flat = jax.tree_util.tree_leaves_with_path
    a, b = dict(flat(params)), dict(flat(back))
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_adamw_steps_match_jax_trainer(params):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(AXIS_ORDER)), AXIS_ORDER)
    jt = JaxTrainer(JaxViT(JaxViTConfig.tiny(dtype=jnp.float32,
                                             **MODEL_KW)),
                    JaxTrainConfig(**TRAIN_KW), mesh)
    jparams = jax.tree.map(jnp.asarray, params)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=jt.optimizer.init(jparams), extra_vars={})
    trainer = Trainer(ViT(ViTConfig.tiny(dtype=torch.float32, **MODEL_KW)),
                      TrainConfig(**TRAIN_KW), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(vit_params_from_jax(params))
    assert state.extra_vars == {}
    for b in _batches(2):
        js, jm = jt.step(js, jt.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}))
        state, tm = trainer.step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        for key in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-6)
    want = vit_params_from_jax(jax.device_get(js.params))
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    lr = TRAIN_KW["learning_rate"]
    for name, t in got.items():
        if name.endswith(".k.bias"):
            continue
        w = want[name]
        assert float((t - w).abs().max()) <= 1e-5 * float(
            w.abs().max()) + 1e-3 * lr, name


def test_dropout_by_generator(params):
    """As tests/test_models.py::TestViTDropout holds the JAX model: two
    generators give different training outputs, eval is deterministic and
    needs none; without a generator training with dropout raises."""
    model = _port(params, dropout=0.5)
    images = torch.from_numpy(_batches(1)[0]["inputs"])
    with torch.no_grad():
        a = model(images, train=True,
                  generator=torch.Generator().manual_seed(1))
        b = model(images, train=True,
                  generator=torch.Generator().manual_seed(2))
        again = model(images, train=True,
                      generator=torch.Generator().manual_seed(1))
        c, d = model(images, train=False), model(images, train=False)
        e = _port(params)(images)
    assert not torch.allclose(a, b)
    assert torch.equal(a, again)
    assert torch.equal(c, d) and torch.equal(c, e)
    with pytest.raises(ValueError, match="generator"):
        model(images, train=True)


def test_trainer_raises_on_dropout_and_adafactor():
    with pytest.raises(ValueError, match="dropout"):
        Trainer(ViT(ViTConfig.tiny(dropout=0.1)), TrainConfig(task="image"),
                device="cpu")
    with pytest.raises(NotImplementedError, match="adafactor"):
        Trainer(ViT(ViTConfig.tiny()),
                TrainConfig(task="image", optimizer="adafactor"),
                device="cpu")


def test_registry_widths_and_cpu_counters():
    with torch.device("meta"):
        model, cfg = get_model("vit-b16")
    assert (cfg.embed_dim, cfg.num_layers, cfg.num_heads, cfg.mlp_dim,
            cfg.num_patches) == (768, 12, 12, 3072, 196)
    assert sum(p.numel() for p in model.parameters()) == 86_567_656
    assert layer_norm_calls(cfg) == 25
    _, large = get_model("vit-l16")
    assert (large.embed_dim, large.num_layers, large.num_heads) == (
        1024, 24, 16)
    before = (layer_norm.fwd_launches, layer_norm.bwd_launches,
              bias_gelu.fwd_launches, bias_gelu.bwd_launches)
    model = ViT(ViTConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(0))
    model(torch.zeros(2, 32, 32, 3), train=True).sum().backward()
    assert (layer_norm.fwd_launches, layer_norm.bwd_launches,
            bias_gelu.fwd_launches, bias_gelu.bwd_launches) == before

"""The port's Llama training against the JAX package's, on the CPU: the
model's parameter grads (with and without remat), the 5-step loss
trajectory against a one-device JAX ``Trainer``, the data stream and the
scanned param layout.

Tolerances: llama-tiny f32 parameter grads atol 1e-6 / rtol 1e-4 (a
2-layer model summed in another order); the 5-step loss trajectory 5e-5
absolute (the gap measured when this test was written: below 1e-6);
grad_norm 1e-4 relative; layouts bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.models.layout import to_layer_layout as jax_to_layer_layout
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train import losses as jlosses
from kubeflow_tpu.train.data import SyntheticTextConfig as JaxTextConfig
from kubeflow_tpu.train.data import synthetic_text as jax_synthetic_text
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.train import losses as tlosses
from kubeflow_tpu_torch.train.data import SyntheticTextConfig, synthetic_text
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

V = 256


# ---------------------------------------------------------------- model grads


TOKENS = np.random.RandomState(4).randint(0, V, (2, 17))


def _jax_model(**kw):
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, **kw)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    return jmodel, params


@pytest.fixture(scope="module")
def grads_params():
    """llama-tiny's JAX params, initialised once for every remat policy
    (a policy changes no parameter, and the tree is the same)."""
    return _jax_model()[1]


@pytest.mark.parametrize("remat", ["none", "full", "qkv_attn", "minimal",
                                   "qkv_attn_lse", "attn_only", "mlp_only",
                                   "dots"])
def test_llama_param_grads_match_jax(grads_params, remat):
    kw = {} if remat == "none" else dict(remat=True, remat_policy=remat)
    jmodel = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, **kw))
    params = grads_params
    inputs, labels = TOKENS[:, :-1], TOKENS[:, 1:]

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(inputs))
        return jlosses.cross_entropy_loss(logits, jnp.asarray(labels),
                                          z_loss_weight=1e-4)[0]

    jloss = jax.jit(jloss)
    jgrads = jax.jit(jax.grad(jloss))(params)
    cfg = LlamaConfig.tiny(dtype=torch.float32, **kw)
    model = Llama(cfg)
    model.load_state_dict(llama_params_from_jax(params, cfg))
    flash_before = flash_attention.fwd_launches
    logits = model(torch.from_numpy(inputs), attn_impl="flash")
    loss, _ = tlosses.cross_entropy_loss(logits, torch.from_numpy(labels),
                                         z_loss_weight=1e-4)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss(params)), atol=1e-6)
    want = llama_params_from_jax(jax.device_get(jgrads), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)
    assert flash_attention.fwd_launches == flash_before   # CPU: no kernel


# ---------------------------------------------------------------- trajectory


def _one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(AXIS_ORDER)),
                AXIS_ORDER)


TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)


def test_data_stream_matches_jax():
    a = synthetic_text(SyntheticTextConfig(batch_size=2, seq_len=9,
                                           vocab_size=V, seed=3))
    b = jax_synthetic_text(JaxTextConfig(batch_size=2, seq_len=9,
                                         vocab_size=V, seed=3))
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["inputs"], next(b)["inputs"])


def test_loss_trajectory_matches_one_device_jax_trainer():
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    jtrainer = JaxTrainer(JaxLlama(jcfg), JaxTrainConfig(**TRAIN_KW),
                          _one_device_mesh())
    stream = synthetic_text(SyntheticTextConfig(batch_size=4, seq_len=16,
                                                vocab_size=V, seed=0))
    batches = [next(stream) for _ in range(5)]
    jstate = jtrainer.init_state(
        jax.random.PRNGKey(0),
        jtrainer.shard_batch({"inputs": jnp.asarray(batches[0]["inputs"])}))
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Llama(cfg), TrainConfig(**TRAIN_KW), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(
        llama_params_from_jax(jax.device_get(jstate.params), cfg))
    gaps = []
    for b in batches:
        jstate, jm = jtrainer.step(
            jstate, jtrainer.shard_batch({"inputs": jnp.asarray(
                b["inputs"])}))
        state, tm = trainer.step(state, {"inputs": torch.from_numpy(
            b["inputs"])})
        gaps.append(abs(float(tm["loss"]) - float(jm["loss"])))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert max(gaps) < 5e-5, gaps
    assert state.step == int(jstate.step) == 5



def test_scanned_layout_round_trip():
    # The JAX bench trains scanned: its tree converts, and back.
    from kubeflow_tpu_torch.models.convert import llama_params_to_jax

    _, params = _jax_model(scan_layers=True)
    cfg = LlamaConfig.tiny(dtype=torch.float32, scan_layers=True)
    sd = llama_params_from_jax(params, cfg)
    back = llama_params_to_jax(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert np.array_equal(a, b)
    unrolled = jax_to_layer_layout(params["params"], 2)
    sd2 = llama_params_from_jax(unrolled, cfg)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)

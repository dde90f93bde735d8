"""The port's Mixtral training against the JAX package's, on the CPU:
every parameter's gradient (aux-loss term included) with remat off and
under "minimal", the other remat policies against remat off in the port,
the 5-step trajectory against a one-device JAX ``Trainer``, and what the
training path leaves out.

Tolerances: parameter grads atol 1e-6 / rtol 1e-4 against JAX, as
tests/test_torch_train_model.py holds Llama (a 2-layer f32 model summed
in another order); the port's policies within 1e-6 relative of remat off
(each policy replays the same ops: the measured gap is 0); the
trajectory's loss within 5e-5 absolute, grad_norm 1e-4 relative and aux
1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh

from kubeflow_tpu.models import Mixtral as JaxMixtral
from kubeflow_tpu.models import MixtralConfig as JaxMixtralConfig
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train import losses as jlosses
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import Mixtral, MixtralConfig
from kubeflow_tpu_torch.models.convert import mixtral_params_from_jax
from kubeflow_tpu_torch.models.llama import REMAT_POLICIES
from kubeflow_tpu_torch.ops import moe as ops
from kubeflow_tpu_torch.parallel import moe as pmoe
from kubeflow_tpu_torch.train import losses as tlosses
from kubeflow_tpu_torch.train.data import SyntheticTextConfig, synthetic_text
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

V = 256
AUX = 0.02
TOKENS = np.random.RandomState(4).randint(0, V, (2, 17))
# A capacity factor that drops choices at these 32 tokens (capacity 12 of
# 64 choices over 4 experts), so the masks reach the gradients.
CAPACITY = 0.75
TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)


def _one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(AXIS_ORDER)),
                AXIS_ORDER)


@pytest.fixture(scope="module")
def jax_run():
    """The one JAX trainer of this file: mixtral-tiny in f32 on one device,
    its initial state and 5 batches of the synthetic stream."""
    jcfg = JaxMixtralConfig.tiny(dtype=jnp.float32)
    jtrainer = JaxTrainer(JaxMixtral(jcfg), JaxTrainConfig(**TRAIN_KW),
                          _one_device_mesh())
    stream = synthetic_text(SyntheticTextConfig(batch_size=4, seq_len=16,
                                                vocab_size=V, seed=0))
    batches = [next(stream) for _ in range(5)]
    jstate = jtrainer.init_state(
        jax.random.PRNGKey(0),
        jtrainer.shard_batch({"inputs": jnp.asarray(batches[0]["inputs"])}))
    return jtrainer, jstate, batches


@pytest.fixture(scope="module")
def jax_params(jax_run):
    """The JAX trainer's initial params (a remat policy changes none)."""
    params = nn.meta.unbox(jax.device_get(jax_run[1].params))
    return params if "params" in params else {"params": params}


def _cfg(remat: str, **kw) -> MixtralConfig:
    kw = dict(kw, capacity_factor=CAPACITY)
    if remat != "none":
        kw.update(remat=True, remat_policy=remat)
    return MixtralConfig.tiny(dtype=torch.float32, **kw)


def _port_grads(params, remat: str):
    """(loss, aux, {name: grad}) of the port's train loss, ce + AUX x the
    layers' mean aux, on TOKENS."""
    cfg = _cfg(remat)
    model = Mixtral(cfg)
    model.load_state_dict(mixtral_params_from_jax(params, cfg))
    inputs, labels = TOKENS[:, :-1], TOKENS[:, 1:]
    logits, aux = model(torch.from_numpy(inputs), return_aux=True)
    ce, _ = tlosses.cross_entropy_loss(logits, torch.from_numpy(labels),
                                       z_loss_weight=1e-4)
    loss = ce + AUX * aux
    loss.backward()
    return loss, aux, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("remat", ["none", "minimal"])
def test_mixtral_param_grads_match_jax(jax_params, remat):
    kw = {} if remat == "none" else dict(remat=True, remat_policy=remat)
    jmodel = JaxMixtral(JaxMixtralConfig.tiny(
        dtype=jnp.float32, capacity_factor=CAPACITY, **kw))
    inputs, labels = TOKENS[:, :-1], TOKENS[:, 1:]

    def jloss(p):
        logits, mut = jmodel.apply(p, jnp.asarray(inputs),
                                   mutable=["losses"])
        aux = jax.tree.leaves(mut["losses"])
        aux = sum(jnp.sum(a) for a in aux) / sum(a.size for a in aux)
        ce = jlosses.cross_entropy_loss(logits, jnp.asarray(labels),
                                        z_loss_weight=1e-4)[0]
        return ce + AUX * aux, aux

    (want_loss, want_aux), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax_params)
    loss, aux, grads = _port_grads(jax_params, remat)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-5)
    cfg = _cfg(remat)
    want = mixtral_params_from_jax(jax.device_get(jgrads), cfg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def remat_off(jax_params):
    return _port_grads(jax_params, "none")


@pytest.mark.parametrize("policy", [p for p in REMAT_POLICIES
                                    if p != "minimal"])
def test_remat_policies_match_remat_off(jax_params, remat_off, policy):
    loss, aux, grads = _port_grads(jax_params, policy)
    want_loss, want_aux, want = remat_off
    assert torch.equal(loss, want_loss) and torch.equal(aux, want_aux)
    for name, g in grads.items():
        w = want[name]
        err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        assert err <= 1e-6, (name, err)


def test_replays_add_no_aux(jax_params, remat_off, monkeypatch):
    """Under remat the backward replays the routing (K12 runs twice a
    layer) after ``Llama.forward`` closed its collection: the layers' aux
    losses are gathered once each, so the loss holds each once."""
    cfg = _cfg("minimal")
    model = Mixtral(cfg)
    model.load_state_dict(mixtral_params_from_jax(jax_params, cfg))
    routed, collected = [], []
    route, aux_losses = pmoe.route, pmoe.aux_losses

    def counting_route(*args, **kw):
        routed.append(torch.is_grad_enabled())
        return route(*args, **kw)

    def watched():
        cm = aux_losses()
        collected.append(cm)
        return cm

    monkeypatch.setattr(pmoe, "route", counting_route)
    monkeypatch.setattr(pmoe, "aux_losses", watched)
    import kubeflow_tpu_torch.models.llama as tllama
    monkeypatch.setattr(tllama, "aux_losses", watched)
    logits, aux = model(torch.from_numpy(TOKENS[:, :-1]), return_aux=True)
    assert len(routed) == cfg.num_layers and len(collected) == 1
    assert pmoe._SOWN.get() is None                    # closed on return
    (logits.sum() + aux).backward()
    assert len(routed) == 2 * cfg.num_layers           # the replays
    assert torch.equal(aux, remat_off[1])


def test_trajectory_matches_one_device_jax_trainer(jax_run):
    """5 adamw steps of mixtral-tiny in f32 through ``Trainer.step``, the
    aux term at 0.02 (the model config's weight: TrainConfig leaves it
    0, as the JAX trainer's rule takes it)."""
    jtrainer, jstate, batches = jax_run
    cfg = MixtralConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Mixtral(cfg), TrainConfig(**TRAIN_KW), device="cpu")
    assert trainer.aux_loss_weight == jtrainer.aux_loss_weight == AUX
    state = trainer.init_state(0)
    trainer.model.load_state_dict(
        mixtral_params_from_jax(jax.device_get(jstate.params), cfg))
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
        np.testing.assert_allclose(float(tm["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=1e-5)
        assert float(tm["aux_loss"]) > 0.5
    assert max(gaps) < 5e-5, gaps
    assert state.step == int(jstate.step) == 5
    # Eval leaves the aux term out.
    ev = trainer.eval_step(state, {"inputs": torch.from_numpy(
        batches[0]["inputs"])})
    assert set(ev) == {"loss", "accuracy"}


def test_training_never_takes_the_combine_mode(jax_params, monkeypatch):
    """K10's combine mode has no backward: with grad enabled a Mixtral
    layer closes as any decoder layer (the combine, K14's Function, then
    the add + norm, K10) and never reaches ``combine_add_rms_norm``; the
    mode stays inference-only and raises under grad."""
    import kubeflow_tpu_torch.models.mixtral as tmixtral

    calls = []
    deferred = tmixtral.combine_add_rms_norm

    def spy(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return deferred(*args, **kw)

    monkeypatch.setattr(tmixtral, "combine_add_rms_norm", spy)
    cfg = _cfg("none")
    model = Mixtral(cfg)
    model.load_state_dict(mixtral_params_from_jax(jax_params, cfg))
    tokens = torch.from_numpy(TOKENS[:, :-1])
    logits = model(tokens)
    assert calls == []
    logits.sum().backward()
    with torch.no_grad():
        assert torch.equal(model(tokens), logits)
    assert calls == [False] * cfg.num_layers
    x = torch.zeros(3, 64, requires_grad=True)
    c = ops.Combine(torch.zeros(9, 64), torch.ones(3), torch.zeros(3),
                    torch.zeros(3, dtype=torch.int32),
                    torch.full((3,), 9, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.add_rms_norm_combine(x, *c, torch.ones(64))


def test_jitter_and_einsum_still_raise(jax_params):
    with pytest.raises(NotImplementedError, match="6c"):
        Trainer(Mixtral(dataclasses.replace(_cfg("none"),
                                            router_jitter=0.01)),
                TrainConfig(), device="cpu")
    cfg = pmoe.Top2GateConfig(num_experts=4, jitter_eps=0.01)
    x, logits = torch.zeros(8, 16), torch.zeros(8, 4)
    with pytest.raises(NotImplementedError, match="6c"):
        pmoe.moe_dispatch(x, logits, lambda e: e, cfg,
                          rng=torch.Generator())
    with pytest.raises(NotImplementedError, match="item 5"):
        pmoe.moe_dispatch(x, logits, lambda e: e, dataclasses.replace(
            cfg, jitter_eps=0.0, dispatch="einsum"))


def test_moe_flops_count_two_experts_a_token():
    """``train_flops_per_token(moe=True)`` on a Mixtral config (which names
    no ``experts_per_token``) counts the top-2 router's two experts a
    token; the JAX package's copy raises AttributeError there (ROADMAP
    Queue 3)."""
    from kubeflow_tpu_torch.train.flops import train_flops_per_token

    cfg = MixtralConfig.tiny()
    E, H, Hkv, D, F = 64, 4, 2, 16, 128
    per_layer = E * H * D + 2 * E * Hkv * D + H * D * E + E * 4 + 2 * 3 * E * F
    n = 2 * per_layer + V * E
    attention = 4 * 64 * H * D * 2 // 2
    assert train_flops_per_token(cfg, 64, moe=True) == 3 * (2 * n + attention)
    # The dense count holds one MLP a layer: the MoE one a second expert
    # and the router beside it.
    dense = train_flops_per_token(cfg, 64)
    assert train_flops_per_token(cfg, 64, moe=True) - dense == (
        3 * 2 * 2 * (3 * E * F + E * 4))

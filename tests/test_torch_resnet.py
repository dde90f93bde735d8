"""The port's ResNet and its image training against the JAX package's, on
the CPU: resnet-tiny forward in train and eval modes from converted JAX
params, ``Trainer(task="image")`` steps against the JAX ``Trainer``
(adamw; sgd with ``grad_accum_steps=2``), ``evaluate``, a checkpoint round
trip that keeps the running statistics, and the raises.

Inputs come from ``synthetic_images`` (bitwise the JAX stream). One JAX
trainer is compiled per optimizer (module fixtures). Tolerances: f32
logits 1e-5 x max |JAX|; bf16 logits 2e-2 x max |JAX|; the running
statistics 1e-5 relative; loss, grad_norm and accuracy 1e-5 relative;
parameters after each step 1e-5 x max |p| a tensor (plus 1e-3 x lr for
adamw: adam divides each gradient entry by its own RMS, so a small
entry's relative f32 error moves an update of size up to lr). adamw's
first step runs at the warmup's lr(0) = 0; its second moves every
parameter, and there one kind of entry is held only to the size of an
update: a BatchNorm bias whose channel reaches the next BatchNorm through
an all-positive ReLU has a gradient that is 0 in exact arithmetic (the
next BatchNorm's mean removes the shift), so adam turns each side's
rounding noise into an update of up to lr. Those entries are the
BatchNorm biases whose JAX first moment is under 1e-4 of its tensor's
largest (resnet-tiny from this seed, after its second step: 3 of
bn_init's 8 biases, at ~1e-6 of the largest, the others at 1e-2 and
over; at most an eighth of the biases, which the test asserts); each is within 2.1 lr of JAX's (adam's second
update is at most 1.0004 lr a side with these betas).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubeflow_tpu.models.resnet import ResNet as JaxResNet
from kubeflow_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu.train.trainer import TrainState as JaxTrainState
from kubeflow_tpu_torch.models import get_model, list_models
from kubeflow_tpu_torch.models.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from kubeflow_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    batch_norm_calls,
)
from kubeflow_tpu_torch.ops.batch_norm import batch_norm
from kubeflow_tpu_torch.train.checkpoint import CheckpointService
from kubeflow_tpu_torch.train.data import SyntheticImageConfig, synthetic_images
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

IMAGE = dict(batch_size=4, image_size=16, num_classes=10, seed=0)
#: resnet-tiny with two blocks in one stage: the first projects its
#: residual, the second adds its input (the identity residual).
MODEL_KW = dict(stage_sizes=(2,))
TRAIN_KW = dict(task="image", learning_rate=1e-2, warmup_steps=1,
                total_steps=10)


def _batches(n=2):
    stream = synthetic_images(SyntheticImageConfig(**IMAGE))
    return [next(stream) for _ in range(n)]


def _mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(AXIS_ORDER)), AXIS_ORDER)


def _jax_batch(trainer, b):
    return trainer.shard_batch({k: jnp.asarray(v) for k, v in b.items()})


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_model():
    """resnet-tiny's params and batch_stats as JAX trees (numpy, f32): the
    port's initialisers from seed 0 (the JAX model's init would compile
    for seconds), the head given weight so logits depend on the features
    and the running statistics moved off 0 and 1."""
    model = ResNet(ResNetConfig.tiny(dtype=torch.float32, **MODEL_KW))
    model.init_weights(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    with torch.no_grad():
        model.head.weight.copy_(torch.from_numpy(
            rs.randn(*model.head.weight.shape).astype(np.float32) * 0.1))
        for _, buf in model.named_buffers():
            buf.add_(torch.from_numpy(
                rs.rand(*buf.shape).astype(np.float32) * 0.2))
    params, stats = resnet_params_to_jax(model.state_dict())
    return params["params"], stats["batch_stats"]


def _port(params, stats, dtype=torch.float32):
    model = ResNet(ResNetConfig.tiny(dtype=dtype, **MODEL_KW))
    model.load_state_dict(resnet_params_from_jax(params, stats))
    return model


def _jax_forward(jmodel, params, stats, images):
    """JAX's train-mode logits and updated batch_stats, then its eval-mode
    logits from those, in one compile. XLA's excess precision is off: it
    would fuse the bf16 ops in f32 (resnet-tiny's logits then move by ~2 %
    of their max: JAX's own jit-versus-op-by-op difference); without it
    each op rounds its bf16 result, as JAX op by op and the port do."""
    def fn(v, x):
        y, upd = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
        return y, upd, jmodel.apply({"params": v["params"], **upd}, x,
                                    train=False)

    args = ({"params": params, "batch_stats": stats}, jnp.asarray(images))
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_forward_matches_jax(jax_model, dtype, tol):
    """Train mode (batch statistics; the updated batch_stats) and eval mode
    (the running ones, nothing updated), from the same converted params."""
    params, stats = jax_model
    jmodel = JaxResNet(JaxResNetConfig.tiny(dtype=getattr(jnp, dtype),
                                            **MODEL_KW))
    images = _batches(1)[0]["inputs"]
    model = _port(params, stats, getattr(torch, dtype))
    jy, upd, jy_eval = _jax_forward(jmodel, params, stats, images)
    y = model(torch.from_numpy(images), train=True)
    assert y.dtype == torch.float32 and y.shape == (4, 10)
    jy = np.asarray(jy)
    assert np.abs(y.detach().numpy() - jy).max() <= tol * np.abs(jy).max()
    want = resnet_params_from_jax(params, upd["batch_stats"])
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6)
    before = {n: b.clone() for n, b in model.named_buffers()}
    jy = np.asarray(jy_eval)
    with torch.no_grad():
        y = model(torch.from_numpy(images), train=False)
    assert np.abs(y.numpy() - jy).max() <= tol * np.abs(jy).max()
    assert all(torch.equal(b, before[n]) for n, b in model.named_buffers())


def test_convert_round_trip(jax_model):
    params, stats = jax_model
    p2, s2 = resnet_params_to_jax(_port(params, stats).state_dict())
    flat = jax.tree_util.tree_leaves_with_path
    for a, b in ((params, p2["params"]), (stats, s2["batch_stats"])):
        la, lb = dict(flat(a)), dict(flat(b))
        assert set(la) == set(lb)
        assert all(np.array_equal(la[k], lb[k]) for k in la)


@dataclasses.dataclass
class Run:
    jax_states: list
    jax_metrics: list
    jax_eval: dict
    trainer: Trainer
    state: object
    metrics: list
    eval: dict
    state_dicts: list


def _run(jax_model, opt, K):
    """Two steps of JAX's and the port's image trainers from the same
    params, then one evaluate batch each; the state dicts after each step.
    The JAX state is built from the params as ``Trainer.init_state``
    builds it, without its random init."""
    params, stats = jax_model
    kw = dict(TRAIN_KW, optimizer=opt, grad_accum_steps=K)
    jt = JaxTrainer(JaxResNet(JaxResNetConfig.tiny(dtype=jnp.float32,
                                                   **MODEL_KW)),
                    JaxTrainConfig(**kw), _mesh())
    batches = _batches(3)
    jparams = jax.tree.map(jnp.asarray, params)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=jt.optimizer.init(jparams),
                       extra_vars={"batch_stats": jax.tree.map(
                           jnp.asarray, stats)})
    trainer = Trainer(ResNet(ResNetConfig.tiny(dtype=torch.float32,
                                               **MODEL_KW)),
                      TrainConfig(**kw), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(resnet_params_from_jax(params, stats))
    jms, tms, jss, sds = [], [], [], []
    for b in batches[:2]:
        js, jm = jt.step(js, _jax_batch(jt, b))
        state, tm = trainer.step(state, _torch_batch(b))
        jms.append(jax.device_get(jm))
        tms.append(tm)
        jss.append(jax.device_get(js))
        sds.append({k: v.clone() for k, v in
                    trainer.model.state_dict().items()})
    return Run(jss, jms, jt.evaluate(js, batches[2:]), trainer, state, tms,
               trainer.evaluate(state, batches[2:]), sds)


@pytest.fixture(scope="module")
def adamw_run(jax_model):
    return _run(jax_model, "adamw", 1)


@pytest.fixture(scope="module")
def sgd_accum_run(jax_model):
    return _run(jax_model, "sgd", 2)


def _noise(js, stats) -> dict:
    """The entries whose update adam makes from rounding noise (the file's
    docstring): BatchNorm biases whose JAX first moment is under 1e-4 of
    its tensor's largest, by the port's parameter name; none for an
    optimizer without a first moment."""
    adam = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    if not adam:
        return {}
    mu = resnet_params_from_jax(jax.device_get(adam[0].mu), stats)
    return {n: m.abs() < 1e-4 * m.abs().max() for n, m in mu.items()
            if n.split(".")[-2].startswith("bn") and n.endswith(".bias")}


@pytest.mark.parametrize("which", ["adamw_run", "sgd_accum_run"])
def test_trainer_steps_match_jax(which, request):
    """Loss, grad_norm and accuracy of each step; the BN running statistics
    and the params after each step (sgd with two microbatches, the
    statistics threaded through them), held as the docstring of this file
    says."""
    run = request.getfixturevalue(which)
    for jm, tm in zip(run.jax_metrics, run.metrics):
        for key in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-6)
    lr = TRAIN_KW["learning_rate"]
    slack = 1e-3 * lr if which == "adamw_run" else 0.0
    for i, (js, got) in enumerate(zip(run.jax_states, run.state_dicts)):
        stats = js.extra_vars["batch_stats"]
        want = resnet_params_from_jax(js.params, stats)
        noise = _noise(js, stats)
        assert set(got) == set(want)
        for name, t in got.items():
            w = want[name]
            err = (t - w).abs()
            tol = 1e-5 * max(float(w.abs().max()), 1e-3)
            if name in noise:
                assert bool((err[noise[name]] <= 2.1 * lr).all()), (i, name)
                err = err[~noise[name]]
                tol += slack
            assert err.numel() == 0 or float(err.max()) <= tol, (i, name)
        # Most BatchNorm biases stay held to the tight bound.
        assert 8 * sum(int(m.sum()) for m in noise.values()) <= sum(
            m.numel() for m in noise.values()), i
    js = run.jax_states[-1]
    assert run.state.step == int(js.step) == 2
    assert set(run.state.extra_vars) == {n for n, _ in
                                         run.trainer.model.named_buffers()}


def test_evaluate_matches_jax(sgd_accum_run):
    """Eval with the running statistics and no z-loss; no perplexity for
    the image task (after the sgd steps, whose params match JAX's)."""
    run = sgd_accum_run
    assert set(run.eval) == set(run.jax_eval) == {"loss", "accuracy"}
    for key in run.eval:
        np.testing.assert_allclose(run.eval[key], run.jax_eval[key],
                                   rtol=1e-5)


def test_checkpoint_keeps_running_statistics(adamw_run, tmp_path):
    run = adamw_run
    svc = CheckpointService(str(tmp_path))
    assert svc.save(run.state.step, run.state)
    svc.wait()
    saved = {n: b.clone() for n, b in run.state.extra_vars.items()}
    params = {n: p.detach().clone() for n, p in run.state.params.items()}
    fresh = Trainer(ResNet(ResNetConfig.tiny(dtype=torch.float32,
                                             **MODEL_KW)),
                    TrainConfig(**TRAIN_KW), device="cpu")
    state = fresh.init_state(7)
    assert not all(torch.equal(state.extra_vars[n], b)
                   for n, b in saved.items())
    restored = svc.restore_latest(state)
    assert restored.step == run.state.step
    assert all(torch.equal(restored.extra_vars[n], b)
               for n, b in saved.items())
    assert all(torch.equal(restored.params[n], p) for n, p in params.items())
    # The restored buffers are the model's own: a train step moves them.
    mean = restored.extra_vars["bn_init.mean"]
    assert mean is dict(fresh.model.named_buffers())["bn_init.mean"]
    fresh.step(restored, _torch_batch(_batches(1)[0]))
    assert not torch.equal(mean, saved["bn_init.mean"])
    svc.close()


def test_registry_and_raises():
    assert {"resnet50", "resnet101", "resnet-tiny", "vit-l16", "vit-b16",
            "vit-tiny"} <= set(list_models())
    with torch.device("meta"):
        model, cfg = get_model("resnet50")
    assert cfg.stage_sizes == (3, 4, 6, 3) and cfg.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert batch_norm_calls(cfg) == 53
    assert len([m for m in model.modules()
                if type(m).__name__ == "BatchNorm"]) == 53
    tiny = ResNet(ResNetConfig.tiny())
    with pytest.raises(NotImplementedError, match="adafactor"):
        Trainer(tiny, TrainConfig(task="image", optimizer="adafactor"),
                device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        Trainer(tiny, TrainConfig(task="audio"), device="cpu")


def test_batch_norm_counts_calls_only_on_the_card():
    """On CPU tensors the plain version runs: the kernel's launch counters
    stay where they were."""
    before = batch_norm.fwd_launches, batch_norm.bwd_launches
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    batch_norm(x, torch.ones(8), torch.zeros(8), torch.zeros(8),
               torch.ones(8), train=True, relu=True).sum().backward()
    assert (batch_norm.fwd_launches, batch_norm.bwd_launches) == before

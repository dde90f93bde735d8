"""The port's training slice against the JAX package's, on the CPU.

Losses, schedules, optimizers, gradient accumulation, evaluation,
checkpoints, the runner and the train -> serve handoff (the model's grads
and the loss trajectory are in tests/test_torch_train_model.py).

Inputs are made from numpy seeds and handed to both sides. Tolerances:
losses 1e-6 (f32, same formulas); schedules 1e-6 relative (the port
evaluates them in float64 on the host, optax in f32); optimizer updates
over 3 steps 1e-6 relative in f32 and one bf16 ulp for bf16 params (the
learning rate's last f32 bit can differ, and the bf16 cast can then round
the other way); accumulated against full-batch steps 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.train import losses as jlosses
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.serving.server import build_server
from kubeflow_tpu_torch.serving.server import env_config as serve_env
from kubeflow_tpu_torch.train import losses as tlosses
from kubeflow_tpu_torch.train import runner
from kubeflow_tpu_torch.train.checkpoint import CheckpointService
from kubeflow_tpu_torch.train.data import SyntheticTextConfig, synthetic_text
from kubeflow_tpu_torch.train.flops import device_peak_tflops
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

V = 256


# ---------------------------------------------------------------- losses


def _logits(seed, shape=(3, 7)):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape, V).astype(np.float32) * 3,
            rs.randint(0, V, shape), (rs.rand(*shape) > 0.3))


@pytest.mark.parametrize("kw", [
    {}, {"z_loss_weight": 1e-2}, {"label_smoothing": 0.1},
    {"z_loss_weight": 1e-3, "label_smoothing": 0.2}])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(kw, masked):
    logits, labels, mask = _logits(0)
    m = mask if masked else None
    want_l, want_c = jlosses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        mask=None if m is None else jnp.asarray(m), **kw)
    got_l, got_c = tlosses.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if m is None else torch.from_numpy(m), **kw)
    np.testing.assert_allclose(float(got_l), float(want_l), atol=1e-6,
                               rtol=1e-6)
    assert float(got_c) == float(want_c)
    acc = tlosses.softmax_accuracy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if m is None else torch.from_numpy(m))
    want_acc = jlosses.softmax_accuracy(
        jnp.asarray(logits), jnp.asarray(labels),
        mask=None if m is None else jnp.asarray(m))
    assert float(acc) == pytest.approx(float(want_acc), abs=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_jax(masked):
    rs = np.random.RandomState(1)
    n, e = 45, 16                              # 45 = 2 blocks of 20 + pad
    hidden = rs.randn(n, e).astype(np.float32)
    kernel = rs.randn(e, V).astype(np.float32) * 0.3    # JAX: [E, V]
    labels = rs.randint(0, V, n)
    mask = (rs.rand(n) > 0.25) if masked else None

    def jloss(h, kern):
        return jlosses.chunked_cross_entropy(
            h, kern, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask),
            z_loss_weight=1e-3, block=20)

    jl, jc, jh = jloss(jnp.asarray(hidden), jnp.asarray(kernel))
    jgh, jgk = jax.grad(lambda h, k: jloss(h, k)[0], argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(kernel))
    th = torch.from_numpy(hidden).requires_grad_()
    tk = torch.from_numpy(np.ascontiguousarray(kernel.T)).requires_grad_()
    tl, tc, thits = tlosses.chunked_cross_entropy(
        th, tk, torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask),
        z_loss_weight=1e-3, block=20)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-6,
                               rtol=1e-6)
    assert float(tc) == float(jc) and float(thits) == float(jh)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(tk.grad.numpy().T, np.asarray(jgk), atol=1e-6)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("sched", ["warmup_cosine", "warmup_linear",
                                   "constant", "rsqrt"])
def test_schedules_match_optax(sched):
    kw = dict(learning_rate=3e-3, warmup_steps=5, total_steps=40,
              lr_schedule=sched)
    want = JaxTrainConfig(**kw).make_schedule()
    got = TrainConfig(**kw).make_schedule()
    for step in range(0, 50):
        np.testing.assert_allclose(got(step), float(want(step)),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"{sched} at step {step}")
    assert got(0) == 0.0


def _opt_case(seed, dtype):
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(4, 8).astype(np.float32),
              "b": rs.randn(8).astype(np.float32)}
    # Step 1 under the clip norm, steps 2-3 over it (clipped).
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.05, 3.0, 0.8)]
    if dtype == "bfloat16":
        cast = lambda t: {k: np.array(jnp.asarray(v, jnp.bfloat16)  # noqa: E731
                                      .astype(jnp.float32))
                          for k, v in t.items()}
        params, grads = cast(params), [cast(g) for g in grads]
    return params, grads


@pytest.mark.parametrize("optimizer,mu_dtype,pdtype", [
    ("adamw", "", "float32"), ("adamw", "bfloat16", "bfloat16"),
    ("lion", "", "float32"), ("sgd", "", "float32")])
def test_optimizer_updates_match_optax(optimizer, mu_dtype, pdtype):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              optimizer=optimizer, mu_dtype=mu_dtype, weight_decay=0.1)
    params, grads = _opt_case(2, pdtype)
    jdt = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    opt = JaxTrainConfig(**kw).make_optimizer()
    jstate = opt.init(jparams)
    tparams = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    topt = TrainConfig(**kw).make_optimizer()
    tstate = topt.init(tparams)
    for g in grads:
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        upd, jstate = opt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate, norm = topt.step(tparams, {k: torch.from_numpy(v).to(tdt)
                                           for k, v in g.items()}, tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v, jnp.float32) for k, v in g.items()})),
            rtol=1e-6)
        for k in params:
            want = np.asarray(jparams[k].astype(jnp.float32))
            got = tparams[k].float().numpy()
            if pdtype == "bfloat16":          # one bf16 ulp
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    assert tstate["count"] == 3
    if optimizer == "adamw" and mu_dtype:
        assert tstate["mu"]["w"].dtype == torch.bfloat16
        assert tstate["nu"]["w"].dtype == torch.float32


def test_first_update_is_zero_and_adafactor_decays():
    params, grads = _opt_case(3, "float32")
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = TrainConfig(warmup_steps=3).make_optimizer()
    topt.step(tparams, {k: torch.from_numpy(v) for k, v in grads[0].items()},
              topt.init(tparams))
    for k in params:                       # lr(0) = 0: decay included
        assert np.array_equal(tparams[k].numpy(), params[k])
    # adafactor adds the decay after the learning rate (the reference's
    # chain, ROADMAP.md Queue 3): at lr(0) = 0 step 1 is p - wd p.
    kw = dict(optimizer="adafactor", warmup_steps=3)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = TrainConfig(**kw).make_optimizer()
    topt.step(tparams, {k: torch.from_numpy(v) for k, v in grads[0].items()},
              topt.init(tparams))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = JaxTrainConfig(**kw).make_optimizer()
    upd, _ = opt.update({k: jnp.asarray(v) for k, v in grads[0].items()},
                        opt.init(jparams), jparams)
    for k, v in params.items():
        want = v - np.float32(0.1) * v
        assert np.array_equal(tparams[k].numpy(), want)
        assert np.array_equal(np.asarray(optax.apply_updates(jparams, upd)[k]),
                              want)


# ---------------------------------------------------------------- accumulation


TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)


def _tiny_trainer(seed=0, **kw):
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Llama(cfg), TrainConfig(**{**TRAIN_KW, **kw}),
                      device="cpu")
    return trainer, trainer.init_state(seed)


@pytest.mark.parametrize("masked", [False, True])
def test_grad_accumulation_matches_full_batch(masked):
    rs = np.random.RandomState(5)
    batch = {"inputs": torch.from_numpy(rs.randint(0, V, (4, 13)))}
    if masked:                 # padding spread unevenly over microbatches
        mask = np.ones((4, 13), np.int32)
        mask[0, 4:] = 0
        mask[1, 9:] = 0
        batch["mask"] = torch.from_numpy(mask)
    results = []
    for k in (1, 2):
        # sgd: the update is linear in the grads (Adam's g / sqrt(nu)
        # would magnify f32 summation noise in near-zero grads).
        trainer, state = _tiny_trainer(grad_accum_steps=k, optimizer="sgd")
        for _ in range(2):             # update 1 runs at lr(0) = 0
            state, m = trainer.step(state, batch)
        results.append((m, {n: p.detach().clone()
                            for n, p in state.params.items()}))
    (m1, p1), (m2, p2) = results
    for key in ("loss", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for n in p1:
        np.testing.assert_allclose(p2[n].numpy(), p1[n].numpy(), atol=1e-6,
                                   err_msg=n)


def test_evaluate_reports_perplexity():
    trainer, state = _tiny_trainer()
    stream = synthetic_text(SyntheticTextConfig(batch_size=2, seq_len=12,
                                                vocab_size=V, seed=9))
    out = trainer.evaluate(state, (next(stream) for _ in range(2)))
    assert set(out) == {"loss", "accuracy", "perplexity"}
    assert out["perplexity"] == pytest.approx(np.exp(out["loss"]))
    assert trainer.evaluate(state, []) == {}


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_resume_continues_trajectory(tmp_path):
    stream = synthetic_text(SyntheticTextConfig(batch_size=2, seq_len=12,
                                                vocab_size=V, seed=1))
    batches = [{"inputs": torch.from_numpy(next(stream)["inputs"])}
               for _ in range(4)]
    kw = dict(mu_dtype="bfloat16")
    trainer, state = _tiny_trainer(**kw)
    straight = []
    for b in batches:
        state, m = trainer.step(state, b)
        straight.append(float(m["loss"]))

    trainer, state = _tiny_trainer(**kw)
    ckpt = CheckpointService(str(tmp_path), max_to_keep=2)
    for b in batches[:2]:
        state, _ = trainer.step(state, b)
        assert ckpt.save(state.step, state)
    assert not ckpt.save(state.step, state)          # already saved
    ckpt.close()
    # Torn saves: a step directory without its marker and a temporary
    # directory left by a crash are never restored.
    os.makedirs(tmp_path / "7")
    torch.save({}, tmp_path / "7" / "params.pt")
    os.makedirs(tmp_path / ".tmp-9-123")
    ckpt = CheckpointService(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step() == 2 and ckpt.all_steps() == [1, 2]

    trainer, fresh = _tiny_trainer(seed=11, **kw)    # other weights
    state = ckpt.restore_latest(fresh)
    assert state.step == 2 and state.opt_state["count"] == 2
    assert state.opt_state["mu"]["embed"].dtype == torch.bfloat16
    resumed = []
    for b in batches[2:]:
        state, m = trainer.step(state, b)
        resumed.append(float(m["loss"]))
    assert resumed == straight[2:]
    ckpt.save(state.step, state)
    ckpt.close()
    assert ckpt.all_steps() == [2, 4]                 # max_to_keep
    params = ckpt.restore_params_latest()
    assert params["step"] == 4
    for n, p in state.params.items():
        assert torch.equal(params["params"][n], p.detach())
    assert CheckpointService(str(tmp_path / "empty")).restore_latest(
        state) is None


# ---------------------------------------------------------------- runner


RUN_ENV = {"KFTPU_PLATFORM": "cpu", "KFTPU_MODEL": "llama-tiny",
           "KFTPU_TRAIN_STEPS": "3", "KFTPU_BATCH_PER_HOST": "2",
           "KFTPU_SEQ_LEN": "16", "KFTPU_ATTN_IMPL": "flash",
           "KFTPU_HPARAMS": json.dumps({"warmup_steps": 1,
                                        "learning_rate": 3e-2})}


def test_runner_writes_termination_log(monkeypatch, tmp_path):
    for k, v in {**RUN_ENV, "KFTPU_EVAL_EVERY": "2",
                 "KFTPU_EVAL_BATCHES": "1",
                 "KFTPU_MODEL_KW": json.dumps({"remat": True,
                                               "remat_policy": "qkv_attn"}),
                 "KFTPU_TERMINATION_LOG": str(tmp_path / "term")}.items():
        monkeypatch.setenv(k, v)
    assert runner.run(runner.env_config()) == 0
    report = json.loads((tmp_path / "term").read_text())
    assert report["steps"] == 3 and np.isfinite(report["loss"])
    assert report["tokens_per_sec"] > 0
    assert {"eval_loss", "eval_accuracy", "eval_perplexity"} <= set(report)


@pytest.mark.parametrize("env,value", [
    ("KFTPU_NUM_PROCESSES", "2"), ("KFTPU_MESH", '{"dp": 1, "tp": 2}'),
    ("KFTPU_TRACE_DIR", "/trace"), ("KFTPU_PROFILE_DIR", "/profile")])
def test_runner_raises_on_unported_env(monkeypatch, env, value):
    for k, v in RUN_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(env, value)
    with pytest.raises(NotImplementedError, match="slice"):
        runner.run(runner.env_config())


def test_runner_needs_cuda_unless_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the no-CUDA rule cannot show")
    for k, v in RUN_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("KFTPU_PLATFORM")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run(runner.env_config())
    assert device_peak_tflops() == 0.0


def test_train_then_serve_from_checkpoint(monkeypatch, tmp_path):
    """Train llama-tiny 3 steps, serve the checkpoint, and hold the served
    greedy tokens against a direct forward of the trained weights."""
    ck = str(tmp_path / "ck")
    for k, v in {**RUN_ENV, "KFTPU_CHECKPOINT_DIR": ck,
                 "KFTPU_TERMINATION_LOG": str(tmp_path / "term")}.items():
        monkeypatch.setenv(k, v)
    runner.run(runner.env_config())
    trained = CheckpointService(ck).restore_params_latest()
    assert trained["step"] == 3
    monkeypatch.setenv("KFTPU_SERVING_CHECKPOINT_DIR", ck)
    monkeypatch.setenv("KFTPU_SERVING_PARAM_DTYPE", "float32")
    monkeypatch.setenv("KFTPU_SERVING_MAX_LEN", "64")
    server = build_server(serve_env())
    engine, model = server.engine, server.engine.model
    for n, p in model.state_dict().items():
        assert torch.equal(p, trained["params"][n]), n
    prompt = [5, 17, 3, 200, 41]
    rid = engine.submit(prompt, max_new_tokens=6)
    engine.run()
    served = engine.result(rid).tokens
    # One causal forward of prompt + served tokens at the engine's RoPE
    # positions (generated token i at L + 1 + i: the JAX engine's decode
    # positions, which the port follows) gives every step's logits.
    L = len(prompt)
    toks = torch.tensor([prompt + served[:-1]])
    pos = torch.tensor([list(range(L)) + [L + 1 + j
                                          for j in range(len(served) - 1)]])
    with torch.no_grad():
        logits = model(toks, positions=pos)[0, L - 1:].float()
    top = logits.max(-1).values
    got = logits.gather(1, torch.tensor(served)[:, None])[:, 0]
    # bf16 activations in both; the batched decode rounds at other places
    # than the full forward, so a served token may trail the max by a few
    # bf16 ulps of these small logits, never by a whole logit gap.
    assert torch.all(top - got <= 2e-2), (top - got).tolist()
    assert int((logits.argmax(-1) == torch.tensor(served)).sum()) >= 3

"""The plain versions beside the port's fused training kernels against the
JAX package, on the CPU: K6 (RMSNorm), K7 (RoPE), K8 (cross-entropy) and K5
(the optimizer step over the chunk table). Off the card each
``torch.autograd.Function`` runs its plain forward and its hand-derived
backward, the formulas the kernels implement; the tests hold both against
``jax.vjp`` of the reference function, and a 2-layer training step through
all four against the one-device JAX trainer's.

Inputs are made from numpy seeds and handed to both sides. Tolerances:
f32 forward and backward 1e-5 relative with an absolute floor of 1e-6 x
the largest element (sums taken in another order); bf16 one ulp (2^-7
relative) with a floor of 2^-8 x the largest element (an element near a
cancellation in dx keeps the absolute error of its terms); K8's loss 1e-6
and its gradient 1e-6 absolute in f32; the optimizer's norm 1e-6 relative,
f32 params 1e-6 relative, bf16 params and mu one bf16 ulp (the learning
rate's last f32 bit can differ and the cast round the other way); the
2-layer step's loss and accuracy 1e-5, grad_norm 1e-4 relative and params
after two steps 1e-5 relative with a 1e-6 floor (1e-4 of the learning rate:
adam divides each grad by its own root mean square, so a grad near zero
carries its relative error whole into its update). The step keeps mu in
f32: with mu in bf16, XLA keeps b1 mu in f32 where the port rounds it to
bf16 (excess precision), a known difference of the optimizer's, not of
the kernels'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.ops import norms as jnorms
from kubeflow_tpu.ops import rope as jrope
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train import losses as jlosses
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.ops import norms, rope
from kubeflow_tpu_torch.ops import optimizer as fused
from kubeflow_tpu_torch.ops.cross_entropy import cross_entropy_sums
from kubeflow_tpu_torch.train import losses as tlosses
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, dtype: str, err_msg: str = ""):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = float(np.abs(want).max()) or 1.0
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -8 * scale, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=err_msg)


def _both(a: np.ndarray, dtype: str):
    """The same values on both sides: rounded to the dtype in JAX first."""
    jdt, tdt = DT[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


# ---------------------------------------------------------------- K6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_forward_and_backward_match_jax(dtype):
    rs = np.random.RandomState(0)
    jx, tx = _both(rs.randn(3, 5, 64) * 2, dtype)
    jw, tw = _both(1 + 0.1 * rs.randn(64), dtype)
    jdy, tdy = _both(rs.randn(3, 5, 64), dtype)
    want, vjp = jax.vjp(lambda x, w: jnorms.rms_norm(x, w, eps=1e-5), jx, jw)
    want_dx, want_dw = vjp(jdy)
    tx.requires_grad_()
    tw.requires_grad_()
    before = norms.rms_norm.fwd_launches, norms.rms_norm.bwd_launches
    y = norms.rms_norm(tx, tw, eps=1e-5)
    y.backward(tdy)
    assert y.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    _close(y, want, dtype, "y")
    _close(tx.grad, want_dx, dtype, "dx")
    _close(tw.grad, want_dw, dtype, "dweight")
    # The CPU runs the plain pair: no kernel was launched.
    assert (norms.rms_norm.fwd_launches,
            norms.rms_norm.bwd_launches) == before


# ---------------------------------------------------------------- K7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_qk_forward_and_backward_match_jax(dtype):
    rs = np.random.RandomState(1)
    D, L = 32, 16
    jq, tq = _both(rs.randn(2, 6, 4, D), dtype)       # 4 query heads,
    jk, tk = _both(rs.randn(2, 6, 2, D), dtype)       # 2 kv heads
    jdq, tdq = _both(rs.randn(2, 6, 4, D), dtype)
    jdk, tdk = _both(rs.randn(2, 6, 2, D), dtype)
    # Positions past the table (>= L) clamp to its last row in both.
    pos = np.array([[0, 5, 15, 16, 40, 3], [7, 7, 2, 31, 1, 9]], np.int64)
    jc, js = jrope.rope_frequencies(D, L)
    tc, ts = rope.rope_frequencies(D, L)

    def jfn(q, k):
        return (jrope.apply_rope(q, jc, js, positions=jnp.asarray(pos)),
                jrope.apply_rope(k, jc, js, positions=jnp.asarray(pos)))

    (want_q, want_k), vjp = jax.vjp(jfn, jq, jk)
    want_dq, want_dk = vjp((jdq, jdk))
    tq.requires_grad_()
    tk.requires_grad_()
    before = rope.apply_rope.fwd_launches, rope.apply_rope.bwd_launches
    q, k = rope.apply_rope_qk(tq, tk, tc, ts,
                              positions=torch.from_numpy(pos))
    torch.autograd.backward([q, k], [tdq, tdk])
    _close(q, want_q, dtype, "q")
    _close(k, want_k, dtype, "k")
    _close(tq.grad, want_dq, dtype, "dq")
    _close(tk.grad, want_dk, dtype, "dk")
    # One tensor alone, positions by default: arange.
    _close(rope.apply_rope(tq.detach(), tc, ts),
           jrope.apply_rope(jq, jc, js), dtype, "q alone")
    assert (rope.apply_rope.fwd_launches,
            rope.apply_rope.bwd_launches) == before


# ---------------------------------------------------------------- K8


def _ce_case(seed, n=24, V=64, ties=True):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(n, V) * 3).astype(np.float32)
    labels = rs.randint(0, V, n)
    if ties:            # rows whose max appears twice: the lowest index wins
        for r in range(0, n, 3):
            a, b = sorted(rs.choice(V, 2, replace=False))
            logits[r, a] = logits[r, b] = logits[r].max() + 1.0
            labels[r] = a if r % 2 else b
    return logits, labels, rs.rand(n) > 0.3


@pytest.mark.parametrize("kw", [
    {"z_loss_weight": 1e-2},
    {"label_smoothing": 0.1},
    {"z_loss_weight": 1e-3, "label_smoothing": 0.2}])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_forward_and_backward_match_jax(kw, masked):
    logits, labels, mask = _ce_case(2)
    m = mask if masked else None

    def jloss(x):
        return jlosses.cross_entropy_loss(
            x, jnp.asarray(labels), mask=None if m is None else
            jnp.asarray(m), **kw)[0]

    want, want_d = jax.value_and_grad(jloss)(jnp.asarray(logits))
    want_acc = jlosses.softmax_accuracy(
        jnp.asarray(logits), jnp.asarray(labels),
        mask=None if m is None else jnp.asarray(m))
    tx = torch.from_numpy(logits).requires_grad_()
    loss, count, hits = tlosses.cross_entropy_stats(
        tx, torch.from_numpy(labels),
        mask=None if m is None else torch.from_numpy(m), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_d),
                               atol=1e-6)
    assert float(hits / count) == pytest.approx(float(want_acc), abs=1e-7)
    assert float(count) == (m.sum() if masked else len(labels))


def test_cross_entropy_bf16_logits_keep_their_dtype_and_sums():
    logits, labels, mask = _ce_case(3)
    jx, tx = _both(logits, "bfloat16")
    want, want_d = jax.value_and_grad(lambda x: jlosses.cross_entropy_loss(
        x, jnp.asarray(labels), mask=jnp.asarray(mask),
        z_loss_weight=1e-4)[0])(jx)
    tx.requires_grad_()
    s_nll, s_w, s_hit = cross_entropy_sums(
        tx, torch.from_numpy(labels), torch.from_numpy(mask),
        z_loss_weight=1e-4)
    (s_nll / s_w).backward()
    assert tx.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float((s_nll / s_w).detach()), float(want),
                               rtol=1e-6)
    _close(tx.grad, want_d, "bfloat16", "dlogits")
    assert float(s_w) == mask.sum() and not s_w.requires_grad


# ---------------------------------------------------------------- K5


def _opt_tensors(seed, pdtype):
    """Odd sizes, one of them over a chunk (two chunks, a ragged tail)."""
    rs = np.random.RandomState(seed)
    shapes = {"big": (fused.CHUNK + 37,), "w": (7, 9), "b": (33,),
              "s": (1,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return {k: _both(v, pdtype) for k, v in params.items()}, rs


@pytest.mark.parametrize("optimizer,mu_dtype,pdtype", [
    ("adamw", "bfloat16", "bfloat16"), ("adamw", "", "float32"),
    ("lion", "", "bfloat16"), ("sgd", "", "float32")])
def test_chunk_table_step_matches_optax(optimizer, mu_dtype, pdtype):
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
              optimizer=optimizer, mu_dtype=mu_dtype, weight_decay=0.1,
              grad_clip_norm=1.0)
    both, rs = _opt_tensors(4, pdtype)
    jparams = {k: j for k, (j, _) in both.items()}
    tparams = {k: t for k, (_, t) in both.items()}
    opt = JaxTrainConfig(**kw).make_optimizer()
    jstate = opt.init(jparams)
    topt = TrainConfig(**kw).make_optimizer()
    tstate = topt.init(tparams)
    # Step 1 under the clip norm, steps 2-3 over it (clipped).
    for scale in (1e-3, 0.5, 0.02):
        g = {k: _both(rs.randn(*v.shape) * scale, pdtype)
             for k, v in jparams.items()}
        upd, jstate = opt.update({k: j for k, (j, _) in g.items()}, jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = {k: t for k, (_, t) in g.items()}
        norm = fused.global_norm_reference([tg[k] for k in tparams])
        want_norm = optax.global_norm(
            {k: j.astype(jnp.float32) for k, (j, _) in g.items()})
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        exact = np.sqrt(sum((t.double() ** 2).sum().item()
                            for t in tg.values()))
        np.testing.assert_allclose(float(norm), exact, rtol=1e-6)
        tstate, got_norm = topt.step(tparams, tg, tstate)
        assert float(got_norm) == float(norm)
        for k in jparams:
            _close(tparams[k], jparams[k], pdtype, k)
    if optimizer == "adamw":
        jmu = optax.tree_utils.tree_get(jstate, "mu")
        for k in jparams:
            _close(tstate["mu"][k], jmu[k], mu_dtype or "float32", "mu")
        assert tstate["nu"]["big"].dtype == torch.float32


def test_chunk_table_cuts_each_tensor_into_chunks():
    g = [torch.ones(fused.CHUNK * 2 + 5), torch.ones(3), torch.zeros(0)]
    assert [fused.chunks_of(t.numel()) for t in g] == [3, 1, 0]
    assert float(fused.global_norm_reference(g)) == pytest.approx(
        np.sqrt(fused.CHUNK * 2 + 8), rel=1e-7)
    with pytest.raises(ValueError, match="adamw"):
        fused.update("adamw", g, g, g, None, torch.ones(()),
                     fused.Hyper(1.0, 0.9, 0.95))


# ---------------------------------------------------------------- the step


def test_two_layer_step_through_the_functions_matches_jax_trainer():
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=20,
              z_loss_weight=1e-3)
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(AXIS_ORDER)), AXIS_ORDER)
    jtrainer = JaxTrainer(JaxLlama(jcfg), JaxTrainConfig(**kw), mesh)
    rs = np.random.RandomState(6)
    batches = [{"inputs": rs.randint(0, 256, (2, 17)),
                "mask": (rs.rand(2, 17) > 0.2).astype(np.int32)}
               for _ in range(2)]
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jtrainer.shard_batch(
        {k: jnp.asarray(v) for k, v in batches[0].items()}))
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    trainer = Trainer(Llama(cfg), TrainConfig(**kw), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(
        llama_params_from_jax(jax.device_get(jstate.params), cfg))
    for b in batches:
        jstate, jm = jtrainer.step(jstate, jtrainer.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}))
        state, tm = trainer.step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), atol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = llama_params_from_jax(jax.device_get(
        nn.meta.unbox(jstate.params)), cfg)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)

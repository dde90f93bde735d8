"""The global norm that adafactor's update computes itself (K11's plain
version folds it into the sums of g^2 its moments take) against the JAX
package's, and the unfactored moments, which K11 now updates in its u^2
pass, against optax's; and the kernel's tile table, which is plain
Python, for the narrow tiles of a 128-wide fast axis.

Inputs are made from numpy seeds and handed to both sides. Tolerances:
the norm within 1e-6 relative of ``ops/optimizer.py::global_norm_reference``
and of ``optax.global_norm`` on the same gradients (f32 sums in another
order); the JAX trainer's reported ``grad_norm`` within 1e-5 (its
gradients come through the JAX model, the port's through the port's: one
f32 rounding apart); moments within 1e-5 relative with a floor of 1e-6 of
the tensor's largest value, as ``tests/test_torch_adafactor.py`` holds
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.models.layout import JaxLeaf, jax_leaves
from kubeflow_tpu_torch.ops import adafactor
from kubeflow_tpu_torch.ops.optimizer import global_norm_reference
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

# name: JAX leaf shape; "w" factors, "norm" and "bias" do not.
SHAPES = {"w": (256, 384), "norm": (256,), "bias": (96,)}
KW = dict(optimizer="adafactor", learning_rate=0.05, warmup_steps=1,
          total_steps=10, weight_decay=0.1)


def _close(got, want, rtol=1e-5, floor=1e-6, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()),
                               err_msg=what)


def _arrays(rs, scale):
    return {n: (rs.randn(*s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _torch(tree):
    return {n: torch.from_numpy(a.copy()) for n, a in tree.items()}


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])       # clipped, not
def test_update_returns_the_unclipped_global_norm(max_norm):
    rs = np.random.RandomState(15)
    params, grads = _arrays(rs, 0.5), _arrays(rs, 0.05)
    leaves = {n: JaxLeaf(n, s) for n, s in SHAPES.items()}
    hyper = adafactor.Hyper(max_norm=max_norm, count=2, lr=0.05,
                            weight_decay=0.1)
    tg = _torch(grads)
    want = float(global_norm_reference(list(tg.values())))
    jax_norm = float(optax.global_norm({n: jnp.asarray(a)
                                        for n, a in grads.items()}))
    norms = {}
    for dtype in (torch.float32, torch.float64):
        tp = _torch(params)
        state = adafactor.init_state(tp, leaves)
        norm = adafactor.update_reference(tp, tg, state, leaves, hyper,
                                          dtype=dtype)
        assert norm.dtype == dtype and norm.shape == ()
        norms[dtype] = float(norm)
    assert norms[torch.float32] == want           # the same function
    for got in (norms[torch.float64], jax_norm):
        assert abs(got - want) <= 1e-6 * want
    # update() on CPU tensors returns the plain version's norm.
    tp = _torch(params)
    state = adafactor.init_state(tp, leaves)
    assert float(adafactor.update(tp, tg, state, leaves, hyper)) == want
    # The clip is the scalar s: the step is optax's clip-then-adafactor.
    opt = optax.chain(optax.clip_by_global_norm(max_norm),
                      optax.adafactor(0.05, weight_decay_rate=0.1))
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    upd, _ = opt.update({n: jnp.asarray(a) for n, a in grads.items()},
                        opt.init(jp), jp)
    for n, a in optax.apply_updates(jp, upd).items():
        _close(tp[n], np.asarray(a), what=n)
    assert (want >= max_norm) == (max_norm == 1e-3)


def test_unfactored_moments_match_optax():
    """Three steps, the first two clipped: v of the unfactored leaves (and
    the factored leaf's v_row, v_col beside them) against optax's."""
    rs = np.random.RandomState(16)
    params = _arrays(rs, 0.5)
    leaves = {n: JaxLeaf(n, s) for n, s in SHAPES.items()}
    opt = JaxTrainConfig(**KW).make_optimizer()
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jstate = opt.init(jp)
    topt = TrainConfig(**KW).make_optimizer(leaves)
    tp = _torch(params)
    tstate = topt.init(tp)
    assert set(tstate["v"]) == {"norm", "bias"}
    for scale in (0.5, 0.2, 1e-4):
        grads = _arrays(rs, scale)
        upd, jstate = opt.update({n: jnp.asarray(a)
                                  for n, a in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate, norm = topt.step(tp, _torch(grads), tstate)
        _close(float(norm), float(optax.global_norm(
            {n: jnp.asarray(a) for n, a in grads.items()})), rtol=1e-6,
            floor=0, what="norm")
        for n in SHAPES:
            _close(tp[n], np.asarray(jp[n]), what=n)
    for key in ("v", "v_row", "v_col"):
        jm = optax.tree_utils.tree_get(jstate, key)
        for n, m in tstate[key].items():
            _close(m.numpy(), np.asarray(jm[n]), what=f"{key} {n}")


def test_trainer_grad_norm_matches_jax_trainer():
    """One adafactor step through both trainers from the same weights and
    batch: the reported grad_norm (the port's from K11's plain version,
    the JAX trainer's ``optax.global_norm``) and the loss."""
    factoring = dict(vocab_size=320, embed_dim=256, num_layers=2,
                     num_heads=2, num_kv_heads=1, head_dim=128, mlp_dim=384,
                     max_seq_len=64)
    train_kw = dict(optimizer="adafactor", learning_rate=1e-2,
                    warmup_steps=1, total_steps=20, grad_clip_norm=0.5)
    jcfg = JaxLlamaConfig(**factoring, dtype=jnp.float32, scan_layers=True)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(AXIS_ORDER)), AXIS_ORDER)
    jtrainer = JaxTrainer(JaxLlama(jcfg), JaxTrainConfig(**train_kw), mesh)
    batch = {"inputs": np.random.RandomState(17).randint(0, 320, (2, 17))}
    jbatch = jtrainer.shard_batch({k: jnp.asarray(v)
                                   for k, v in batch.items()})
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jbatch)
    cfg = LlamaConfig(**factoring, dtype=torch.float32, scan_layers=True)
    trainer = Trainer(Llama(cfg), TrainConfig(**train_kw), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(
        llama_params_from_jax(jax.device_get(jstate.params), cfg))
    _, jm = jtrainer.step(jstate, jbatch)
    _, tm = trainer.step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert float(jm["grad_norm"]) > train_kw["grad_clip_norm"]   # clipped
    _close(float(tm["grad_norm"]), float(jm["grad_norm"]), floor=0,
           what="grad_norm")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=5e-5)


def test_plan_gives_a_128_wide_fast_axis_narrow_tiles():
    """The kernel's table on the CPU (the plan is plain Python): o_proj's
    fast axis, its 128-wide head_dim, takes 128 x 128 tiles; every other
    factored tensor 256 x 64; each tensor's tiles cover it, in order."""
    cfg = LlamaConfig(vocab_size=320, embed_dim=256, num_layers=2,
                      num_heads=2, num_kv_heads=1, head_dim=128, mlp_dim=384,
                      scan_layers=True)
    params = {n: p.detach() for n, p in Llama(cfg).named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    leaves = jax_leaves(cfg)
    state = adafactor.init_state(params, leaves)
    plan = adafactor._plan(params, grads, state, leaves, torch.device("cpu"))
    rows = [dict(zip(adafactor.FIELDS, r)) for r in plan.table.tolist()]
    first = 0
    for name, f in zip(plan.order, rows):
        assert f["first"] == first, name
        if not f["flags"] & adafactor._FACTORED:
            first += -(-f["numel"] // (adafactor.TILE_F * adafactor.TILE_S))
            continue
        narrow = bool(f["flags"] & adafactor._NARROW)
        assert narrow == ("o_proj" in name) == (f["nF"] == 128), name
        tile_f, tile_s = ((adafactor.NARROW_F, adafactor.NARROW_S) if narrow
                          else (adafactor.TILE_F, adafactor.TILE_S))
        assert (f["tilesF"], f["tilesS"]) == (-(-f["nF"] // tile_f),
                                              -(-f["nS"] // tile_s)), name
        batch = f["nA"] * f["nB"]
        assert batch * f["nF"] * f["nS"] == f["numel"], name
        first += batch * f["tilesF"] * f["tilesS"]
    assert first == plan.tiles
    assert plan.leaf_at + len(adafactor.blocks(params, leaves)) == \
        plan.scratch

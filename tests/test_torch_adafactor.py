"""adafactor (K11's plain version and the trainer around it) against the
JAX package's: ``TrainConfig(optimizer="adafactor").make_optimizer()``,
optax's adafactor behind the global clip under ``_f32_moments``.

Inputs are made from numpy seeds and handed to both sides. Tolerances:
moments and f32 params within 1e-5 relative, with a floor of 1e-6 of the
tensor's largest value (the means and block RMS are summed in another
order than XLA's); bf16 params within one bf16 ulp of each step's
reference (2^-7 relative, an element below 2^-8 of the tensor's largest
compared at that scale, as the card tests do: a sum one f32 ulp off can
flip a rounding, and p - u cancels; each step starts from the
reference's params, so flips do not compound); the 5-step trajectory's
losses within 5e-5; a checkpoint resume bitwise.

Which axes factor, and what a block is, follow the JAX leaf: the cases
below hold leaves that are stacked over layers or not, a q-like kernel
the port keeps transposed, a tie in ``np.argsort``'s order ([128, 4,
128]) and leaves too small to factor.
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
from kubeflow_tpu.topology.mesh import AXIS_ORDER
from kubeflow_tpu.train.trainer import TrainConfig as JaxTrainConfig
from kubeflow_tpu.train.trainer import Trainer as JaxTrainer
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.models.layout import JaxLeaf, jax_leaves
from kubeflow_tpu_torch.ops import adafactor
from kubeflow_tpu_torch.train.checkpoint import CheckpointService
from kubeflow_tpu_torch.train.trainer import TrainConfig, Trainer

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

L = 2
# name: (JAX leaf shape (stacked: one layer's), stacked over L layers,
# the port keeps [out, in] of a [in, heads, head_dim] kernel).
LEAVES = {
    "q": ((256, 2, 128), True, True),        # [E, H, Dh], factors E and Dh
    "norm": ((256,), True, False),           # [L, 256]: 256 >= 128 > L
    "o": ((2, 128, 256), False, False),
    "mlp": ((256, 384), False, False),
    "tie": ((128, 4, 128), False, False),    # argsort's order picks d1
    "bias": ((96,), False, False),
}


def _close(got, want, rtol=1e-5, floor=1e-6, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()),
                               err_msg=what)


def _tree(rs, scale):
    """{JAX leaf name: array}, stacked leaves with their layer axis."""
    return {n: (rs.randn(*(((L,) if stacked else ()) + shape)) * scale)
            .astype(np.float32) for n, (shape, stacked, _) in LEAVES.items()}


def _port_names(scanned):
    """Port tensor name -> (JAX leaf name, layer or None) and its JaxLeaf."""
    out = {}
    for n, (shape, stacked, transposed) in LEAVES.items():
        for i in (range(L) if stacked else (None,)):
            name = n if i is None else f"{n}.{i}"
            if i is None:
                leaf = JaxLeaf(n, shape, transposed)
            elif scanned:
                leaf = JaxLeaf(f"layers/{n}", shape, transposed, i, L)
            else:
                leaf = JaxLeaf(f"layer_{i}/{n}", shape, transposed)
            out[name] = (n, i, leaf)
    return out


def _to_port(tree, names, dtype):
    """The port's tensors: a layer's slice, [out, in] where transposed."""
    out = {}
    for name, (n, i, leaf) in names.items():
        a = tree[n] if i is None else tree[n][i]
        if leaf.transposed:
            a = a.reshape(a.shape[0], -1).T
        out[name] = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return out


def _jax_tree(tree, names, scanned):
    """The JAX tree: stacked leaves as they are when scanned, else split
    into one leaf a layer."""
    if scanned:
        return dict(tree)
    out = {}
    for name, (n, i, _) in names.items():
        out[name] = tree[n] if i is None else tree[n][i]
    return out


@pytest.mark.parametrize("wd", [0.1, 0.0])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scanned", [True, False])
def test_plain_adafactor_matches_optax(scanned, pdtype, wd):
    kw = dict(optimizer="adafactor", learning_rate=0.05, warmup_steps=1,
              total_steps=10, weight_decay=wd)
    rs = np.random.RandomState(3)
    names = _port_names(scanned)
    jdt = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
    params = _tree(rs, 0.5)
    jparams = {k: jnp.asarray(v, jdt)
               for k, v in _jax_tree(params, names, scanned).items()}
    tparams = _to_port(params, names, tdt)
    leaves = {name: leaf for name, (_, _, leaf) in names.items()}
    opt = JaxTrainConfig(**kw).make_optimizer()
    jstate = opt.init(jparams)
    # Jitted: one program for the chain (op by op, its first call paid a
    # compile for every small op of it).
    update, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    topt = TrainConfig(**kw).make_optimizer(leaves)
    tstate = topt.init(tparams)
    # Step 1 under the clip norm (lr 0: the decay alone), 2 and 3 over it.
    for scale in (0.001, 0.5, 0.05):
        grads = _tree(rs, scale)
        if pdtype == "bfloat16":
            grads = {k: np.asarray(jnp.asarray(v, jdt).astype(jnp.float32))
                     for k, v in grads.items()}
        upd, jstate = update(
            {k: jnp.asarray(v, jdt) for k, v in _jax_tree(
                grads, names, scanned).items()}, jstate, jparams)
        jparams = apply(jparams, upd)
        tstate, _ = topt.step(tparams, _to_port(grads, names, tdt), tstate)
        want = _to_port({k: np.asarray(v.astype(jnp.float32))
                         for k, v in (jparams.items() if scanned else
                                      _restack(jparams, names).items())},
                        names, torch.float32)
        for name, t in tparams.items():
            if pdtype == "bfloat16":
                _close(t.float(), want[name], rtol=2 ** -7, floor=2 ** -15,
                       what=name)
                # One step's flips are the check; the next step starts
                # from the reference's params, so flips do not compound.
                t.copy_(want[name])
            else:
                _close(t, want[name], what=name)
    assert tstate["count"] == 3
    for key in ("v_row", "v_col", "v"):
        jm = optax.tree_utils.tree_get(jstate, key)
        if not scanned:
            jm = _restack(jm, names, key, tstate)
        for n, (shape, stacked, _) in LEAVES.items():
            parts = [name for name, (m, _, _) in names.items() if m == n]
            if parts[0] not in tstate[key]:
                continue
            got = [tstate[key][p].numpy() for p in parts]
            got = np.stack(got) if stacked else got[0]
            _close(got, jm[n], what=f"{key} {n}")


def _restack(tree, names, key=None, tstate=None):
    """A per-layer JAX tree back to {leaf name: stacked array}; for a
    moment, only what the port keeps (optax holds [1] placeholders)."""
    out = {}
    for n, (_, stacked, _) in LEAVES.items():
        parts = [name for name, (m, _, _) in names.items() if m == n]
        if key is not None and parts[0] not in tstate[key]:
            continue
        arrs = [np.asarray(tree[p], np.float32) for p in parts]
        out[n] = np.stack(arrs) if stacked else arrs[0]
    return out


def test_which_axes_factor_follow_the_jax_leaf():
    cfg = LlamaConfig(vocab_size=320, embed_dim=256, num_layers=12,
                      num_heads=2, num_kv_heads=1, head_dim=128, mlp_dim=384)
    got = {n: leaf.factored_dims() for n, leaf in jax_leaves(cfg).items()}
    # q_proj [E, H, Dh] stacked [12, 256, 2, 128]: d0 = E, d1 = Dh; the
    # stacked norms [12, 256] do not factor; embed [V, E]: d0 = V.
    assert got["layers.3.attn.q_proj.weight"] == (2, 0)
    assert got["layers.3.attn.o_proj.weight"] == (1, 2)
    assert got["layers.0.input_norm.weight"] is None
    assert got["embed"] == (1, 0) and got["lm_head.weight"] == (0, 1)
    tie = JaxLeaf("t", (128, 4, 128))
    assert tie.factored_dims() == tuple(int(a) for a in np.argsort(
        (128, 4, 128))[-2:])
    with pytest.raises(ValueError, match="stacked layer axis"):
        JaxLeaf("n", (256,), layer=0, layers=512).factored_dims()
    # The views share the port tensor's memory.
    w = torch.zeros(2 * 128, 256)
    leaf = jax_leaves(cfg)["layers.0.attn.q_proj.weight"]
    leaf.view(w)[5, 1, 7] = 1.0
    assert w[128 + 7, 5] == 1.0


# A config whose projections factor (embed 256, head_dim 128, MLP 384).
FACTORING = dict(vocab_size=320, embed_dim=256, num_layers=2, num_heads=2,
                 num_kv_heads=1, head_dim=128, mlp_dim=384, max_seq_len=64)
TRAIN_KW = dict(optimizer="adafactor", learning_rate=1e-2, warmup_steps=1,
                total_steps=20, z_loss_weight=1e-3)


def _batches(n, seed=6):
    rs = np.random.RandomState(seed)
    return [{"inputs": rs.randint(0, 320, (2, 17))} for _ in range(n)]


def test_five_step_trajectory_matches_jax_trainer():
    jcfg = JaxLlamaConfig(**FACTORING, dtype=jnp.float32, scan_layers=True)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(AXIS_ORDER)), AXIS_ORDER)
    jtrainer = JaxTrainer(JaxLlama(jcfg), JaxTrainConfig(**TRAIN_KW), mesh)
    batches = _batches(5)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jtrainer.shard_batch(
        {k: jnp.asarray(v) for k, v in batches[0].items()}))
    cfg = LlamaConfig(**FACTORING, dtype=torch.float32, scan_layers=True)
    trainer = Trainer(Llama(cfg), TrainConfig(**TRAIN_KW), device="cpu")
    state = trainer.init_state(0)
    trainer.model.load_state_dict(
        llama_params_from_jax(jax.device_get(jstate.params), cfg))
    for b in batches:
        jstate, jm = jtrainer.step(jstate, jtrainer.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}))
        state, tm = trainer.step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=5e-5)
    assert state.opt_state["v_row"] and state.opt_state["v"]
    want = llama_params_from_jax(jax.device_get(
        nn.meta.unbox(jstate.params)), cfg)
    for name, p in trainer.model.named_parameters():
        _close(p.detach(), want[name], rtol=1e-4, what=name)


def _run(trainer, state, batches):
    for b in batches:
        state, _ = trainer.step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    return state


def test_checkpoint_resume_is_bitwise(tmp_path):
    cfg = LlamaConfig(**FACTORING, dtype=torch.float32, scan_layers=True)
    batches = _batches(4, seed=9)
    straight = Trainer(Llama(cfg), TrainConfig(**TRAIN_KW), device="cpu")
    s4 = _run(straight, straight.init_state(1), batches)

    first = Trainer(Llama(cfg), TrainConfig(**TRAIN_KW), device="cpu")
    s2 = _run(first, first.init_state(1), batches[:2])
    ckpt = CheckpointService(str(tmp_path))
    ckpt.save(s2.step, s2)
    ckpt.close()
    second = Trainer(Llama(cfg), TrainConfig(**TRAIN_KW), device="cpu")
    restored = CheckpointService(str(tmp_path)).restore_latest(
        second.init_state(5))
    assert restored.step == 2 and restored.opt_state["count"] == 2
    s4b = _run(second, restored, batches[2:])
    for name, p in s4.params.items():
        assert torch.equal(p, s4b.params[name]), name
    for key in ("v_row", "v_col", "v"):
        for name, m in s4.opt_state[key].items():
            assert torch.equal(m, s4b.opt_state[key][name]), (key, name)


def test_update_dispatch_and_state_layout():
    params = {"w": torch.randn(256, 128), "b": torch.randn(8)}
    leaves = adafactor.default_leaves(params)
    st = adafactor.init_state(params, leaves)
    assert set(st["v_row"]) == {"w"} and set(st["v"]) == {"b"}
    assert st["v_row"]["w"].shape == (128,)      # without d0 = 0 (256)
    assert st["v_col"]["w"].shape == (256,)
    before = adafactor.update.launches
    norm = adafactor.update(params, {k: torch.ones_like(v) for k, v in
                                     params.items()}, st, leaves,
                            adafactor.Hyper(max_norm=1.0, count=0, lr=0.1))
    assert adafactor.update.launches == before      # CPU: the plain version
    assert float(norm) == float(np.float32(np.sqrt(256 * 128 + 8)))
    assert adafactor.Hyper(1.0, 0, 0.0).scalars()[1] == 0.0  # decay at t=1

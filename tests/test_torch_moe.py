"""The port's top-2 MoE routing and dispatch (``parallel/moe.py`` over the
plain versions of ``ops/moe.py``) against the JAX package's
``kubeflow_tpu.parallel.moe``.

Inputs come from numpy seeds and are handed to both sides. Tolerances:
integer outputs (expert ids, positions) equal; gates and the aux loss
within 1e-6 (the softmax's and the means' sums run in another order than
XLA's); the dispatched output, f32, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu_torch.ops import moe as ops
from kubeflow_tpu_torch.parallel.moe import (
    Top2GateConfig,
    group_tokens,
    moe_dispatch,
    top2_gating,
    top2_routing_reference,
)

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

E, M = 8, 16


def _logits(rs, T, skew=0.0, ties=False):
    x = rs.standard_normal((T, E)).astype(np.float32)
    if ties:                          # equal gates: first index wins
        x = np.round(x).astype(np.float32)
    x[:, 1] += skew                   # one hot expert: capacity drops
    return x


# (T, skew, capacity_factor, group_size, ties): one group, a hot expert
# that drops first and second choices, a tight and a loose capacity, two
# groups, a T that group_size does not divide (96 in groups of 48), and
# tied logits.
ROUTING = {
    "plain": (32, 0.0, 1.25, 0, False),
    "skewed_drops": (64, 3.0, 1.25, 0, False),
    "tight_capacity": (40, 1.0, 0.5, 0, False),
    "loose_capacity": (24, 1.0, 2.0, 0, False),
    "groups": (64, 2.0, 1.0, 32, False),
    "indivisible_groups": (96, 2.0, 1.0, 64, False),
    "ties": (32, 0.0, 1.25, 0, True),
}


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_routing_matches_jax(name):
    T, skew, cf, group_size, ties = ROUTING[name]
    rs = np.random.RandomState(sorted(ROUTING).index(name))
    logits = _logits(rs, T, skew, ties)
    cfg = Top2GateConfig(num_experts=E, capacity_factor=cf,
                         group_size=group_size)
    jcfg = jmoe.Top2GateConfig(num_experts=E, capacity_factor=cf,
                               group_size=group_size)
    g = group_tokens(T, cfg) or T
    assert g == (48 if name == "indivisible_groups" else
                 32 if name == "groups" else T)
    dropped = 0
    for q in range(T // g):
        part = logits[q * g:(q + 1) * g]
        want = jax.jit(lambda l: jmoe.top2_routing(l, jcfg))(
            jnp.asarray(part))
        got = top2_routing_reference(torch.from_numpy(part), cfg)
        for w, t in zip(want[:4], got[:4]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        for w, t in zip(want[4:], got[4:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
        dropped += int((got[4] == 0).sum() + (got[5] == 0).sum())
    if skew >= 2.0 or name == "tight_capacity":
        assert dropped > 0


def test_route_index_maps():
    """K12's plain version: the kept choices' slots are distinct and lie
    in their group's region of their expert's buffer, the slots hold their
    tokens, dropped choices point at the trash row, and the groups' aux
    losses are top2_routing's."""
    rs = np.random.RandomState(7)
    T, G, C = 64, 2, 12
    logits = torch.from_numpy(_logits(rs, T, skew=2.0))
    r = ops.route(logits, G, C, torch.float32)
    S = E * G * C
    assert r.slot_tok.shape == r.slot_valid.shape == (S,)
    kept = []
    for dest, w in ((r.dest1, r.g1), (r.dest2, r.g2)):
        assert bool(((dest == S) == (w == 0)).all())
        for t in torch.nonzero(dest < S)[:, 0].tolist():
            s = int(dest[t])
            assert (s % (G * C)) // C == t // (T // G)      # its group
            assert int(r.slot_tok[s]) == t and float(r.slot_valid[s]) == 1
            kept.append(s)
    assert len(set(kept)) == len(kept) == int(r.slot_valid.sum())
    assert (r.dest1 == S).any()
    jcfg = jmoe.Top2GateConfig(num_experts=E, capacity_factor=1.5)
    assert jcfg.capacity(T // G) == C
    want = jax.jit(jax.vmap(lambda l: jmoe.top2_routing(l, jcfg)[-1]))(
        jnp.asarray(logits.numpy().reshape(G, T // G, E)))
    np.testing.assert_allclose(r.aux.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_gating_matches_jax():
    rs = np.random.RandomState(3)
    logits = _logits(rs, 24, skew=2.0)
    cfg = Top2GateConfig(num_experts=E)
    jcfg = jmoe.Top2GateConfig(num_experts=E)
    want = jax.jit(lambda l: jmoe.top2_gating(l, jcfg))(jnp.asarray(logits))
    got = top2_gating(torch.from_numpy(logits), cfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6)


@pytest.fixture(scope="module")
def experts():
    """One expert function's weights [E, M, M] and bias [E, 1, M], shared
    by both sides."""
    rs = np.random.RandomState(11)
    w = (rs.standard_normal((E, M, M)) * 0.3).astype(np.float32)
    b = rs.standard_normal((E, 1, M)).astype(np.float32)

    def jax_fn(e_in):
        return jnp.tanh(jnp.einsum("ecm,emh->ech", e_in, w) + b)

    def torch_fn(e_in):
        return torch.tanh(torch.bmm(e_in, torch.from_numpy(w))
                          + torch.from_numpy(b))

    return jax_fn, torch_fn


# (T, skew, capacity_factor, group_size)
DISPATCH = {
    "one_group": (48, 0.0, 1.25, 8192),
    "drops": (64, 3.0, 1.0, 8192),
    "groups": (128, 2.0, 1.0, 64),
    "indivisible_groups": (96, 2.0, 1.25, 64),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_matches_jax(experts, name):
    T, skew, cf, group_size = DISPATCH[name]
    rs = np.random.RandomState(20 + sorted(DISPATCH).index(name))
    x = rs.standard_normal((T, M)).astype(np.float32)
    logits = _logits(rs, T, skew)
    jax_fn, torch_fn = experts
    jcfg = jmoe.Top2GateConfig(num_experts=E, capacity_factor=cf,
                               group_size=group_size, dispatch="gather")
    want, waux = jax.jit(lambda a, b: jmoe.moe_dispatch(a, b, jax_fn, jcfg))(
        jnp.asarray(x), jnp.asarray(logits))
    before = (ops.route.launches, ops.gather_rows.launches,
              ops.combine_rows.launches)
    got, aux = moe_dispatch(
        torch.from_numpy(x), torch.from_numpy(logits), torch_fn,
        Top2GateConfig(num_experts=E, capacity_factor=cf,
                       group_size=group_size))
    assert (ops.route.launches, ops.gather_rows.launches,
            ops.combine_rows.launches) == before      # CPU: plain versions
    assert got.dtype == torch.float32 and got.shape == (T, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6)


def test_gather_and_combine_match_jax():
    rs = np.random.RandomState(5)
    T, G, C = 32, 1, 8
    logits = torch.from_numpy(_logits(rs, T, skew=2.0))
    r = ops.route(logits, G, C, torch.float32)
    x = rs.standard_normal((T, M)).astype(np.float32)
    S = E * G * C
    want = jmoe._gather_in(jnp.asarray(x), jnp.asarray(r.slot_tok.numpy()),
                           jnp.asarray(r.slot_valid.numpy()),
                           jnp.asarray(r.dest1.numpy()),
                           jnp.asarray(r.dest2.numpy()))
    got = ops.gather_rows(torch.from_numpy(x), r.slot_tok, r.slot_valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = rs.standard_normal((S, M)).astype(np.float32)
    slot_tok = np.concatenate([r.slot_tok.numpy(), [0]]).astype(np.int32)
    want = jmoe._combine_out(jnp.asarray(y), jnp.asarray(r.g1.numpy()),
                             jnp.asarray(r.g2.numpy()),
                             jnp.asarray(r.dest1.numpy()),
                             jnp.asarray(r.dest2.numpy()),
                             jnp.asarray(slot_tok))
    got = ops.combine_rows(torch.from_numpy(y), r.g1, r.g2, r.dest1,
                           r.dest2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_einsum_and_jitter_raise(experts):
    x, logits = torch.zeros(8, M), torch.zeros(8, E)
    with pytest.raises(NotImplementedError, match="item 5"):
        moe_dispatch(x, logits, experts[1],
                     Top2GateConfig(num_experts=E, dispatch="einsum"))
    with pytest.raises(NotImplementedError, match="6c"):
        moe_dispatch(x, logits, experts[1],
                     Top2GateConfig(num_experts=E, jitter_eps=0.1),
                     rng=torch.Generator())
    with pytest.raises(ValueError, match="dispatch"):
        moe_dispatch(x, logits, experts[1],
                     Top2GateConfig(num_experts=E, dispatch="ragged"))

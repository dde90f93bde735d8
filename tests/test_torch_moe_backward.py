"""The plain versions of the MoE dispatch's backward kernels (``ops/moe.py``:
K16 the gather's, K17 the combine's, K18 the router's) against the JAX
package's VJPs (``kubeflow_tpu/parallel/moe.py``: ``_gather_in``,
``_combine_out`` and the autodiff of ``top2_routing``), and the ops'
autograd Functions on the CPU.

Inputs come from numpy seeds and go to both sides, at one group and at
two, with a capacity that drops choices (hot expert 1). Tolerances: K16
bitwise in f32 and bf16 (the two rows widened and added in f32, rounded
once: JAX's bf16 add); K17's dy bitwise, dg1 and dg2 within 1e-6 of
max|dg| (a row dot summed in another order than XLA's); K18 within 1e-5
of max|dl| in f32 (the softmax's and the renormalisation's derivatives
in another order). The router's backward also passes
``torch.autograd.gradcheck`` in f64 (logits away from ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import moe as jmoe
from kubeflow_tpu_torch.ops import moe as ops

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

E, M = 8, 40
# (groups, tokens a group, capacity factor): one group and two, each with
# a capacity that drops first and second choices.
CASES = {"one_group": (1, 64, 0.75), "two_groups": (2, 40, 0.5)}


def _routing(name):
    G, g, cf = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    logits = rs.standard_normal((G * g, E)).astype(np.float32)
    logits[:, 1] += 1.5                           # a hot expert
    cfg = jmoe.Top2GateConfig(num_experts=E, capacity_factor=cf)
    C = cfg.capacity(g)
    r = ops.route_reference(torch.from_numpy(logits), G, C, torch.float32)
    return rs, logits, cfg, G, g, C, r


def _slot_tok_padded(r):
    """The JAX dispatch's slot_tok [S + 1] (the trash entry appended)."""
    return jnp.asarray(np.concatenate([r.slot_tok.numpy(), [0]]),
                       jnp.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_backward_is_the_jax_vjp(name, dtype):
    rs, _, _, G, g, _, r = _routing(name)
    S = r.slot_tok.shape[0]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = jnp.asarray(rs.standard_normal((G * g, M)), jdt)
    d = rs.standard_normal((S, M)).astype(np.float32)

    @jax.jit
    def vjp(x, d, tok, valid, d1, d2):
        return jax.vjp(lambda x: jmoe._gather_in(x, tok, valid, d1, d2),
                       x)[1](d)[0]

    want = vjp(x, jnp.asarray(d, jdt), jnp.asarray(r.slot_tok.numpy()),
               jnp.asarray(r.slot_valid.numpy()).astype(jdt),
               jnp.asarray(r.dest1.numpy()), jnp.asarray(r.dest2.numpy()))
    got = ops.gather_rows_backward_reference(
        torch.from_numpy(d).to(tdt), r.dest1, r.dest2)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_combine_backward_matches_the_jax_vjp(name, dtype):
    rs, _, _, G, g, _, r = _routing(name)
    S = r.slot_tok.shape[0]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y = jnp.asarray(rs.standard_normal((S, M)), jdt)
    # The forward rounds its f32 output to y's dtype: the cotangent comes
    # in that dtype and widens exactly.
    dout = jnp.asarray(rs.standard_normal((G * g, M)), jdt)

    @jax.jit
    def vjp(y, a, b, d1, d2, tok, dout):
        return jax.vjp(lambda y, a, b: jmoe._combine_out(
            y, a, b, d1, d2, tok), y, a, b)[1](dout)

    wdy, wg1, wg2 = vjp(y, jnp.asarray(r.g1.numpy()),
                        jnp.asarray(r.g2.numpy()),
                        jnp.asarray(r.dest1.numpy()),
                        jnp.asarray(r.dest2.numpy()), _slot_tok_padded(r),
                        dout.astype(jnp.float32))
    dy, dg1, dg2 = ops.combine_rows_backward_reference(
        torch.tensor(np.asarray(dout, np.float32)).to(tdt),
        torch.tensor(np.asarray(y, np.float32)).to(tdt), r.g1, r.g2,
        r.dest1, r.dest2, r.slot_tok)
    assert dy.dtype == tdt and dg1.dtype == torch.float32
    np.testing.assert_array_equal(dy.float().numpy(),
                                  np.asarray(wdy, np.float32))
    for got, want in ((dg1, wg1), (dg2, wg2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_row_dot_order():
    """K17's order: lane l's chunks l, l + 32, .. summed in turn, then
    the 8 partial sums and the 32 lanes folded by halves."""
    rs = np.random.RandomState(3)
    a = torch.from_numpy(rs.standard_normal((3, 600)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((3, 600)).astype(np.float32))
    p = torch.cat([a * b, torch.zeros(3, 168)], 1).view(3, 3, 32, 8)
    acc = p[:, 0] + p[:, 1] + p[:, 2]
    for h in (4, 2, 1):
        acc = acc[..., :h] + acc[..., h:2 * h]
    acc = acc[..., 0]
    for h in (16, 8, 4, 2, 1):
        acc = acc[:, :h] + acc[:, h:2 * h]
    assert torch.equal(ops.row_dot_reference(a, b), acc[:, 0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_backward_matches_the_jax_vjp(name):
    rs, logits, cfg, G, g, C, r = _routing(name)
    S = E * G * C
    assert (r.dest1 == S).any() and (r.dest2 == S).any()
    dg1, dg2 = (rs.standard_normal(G * g).astype(np.float32)
                for _ in range(2))
    daux = rs.standard_normal(G).astype(np.float32)

    def routed(lg):
        out = jax.vmap(lambda x: jmoe.top2_routing(x, cfg))(
            lg.reshape(G, g, E))
        return out[4].reshape(-1), out[5].reshape(-1), out[6]

    want = jax.jit(lambda lg, ct: jax.vjp(routed, lg)[1](ct)[0])(
        jnp.asarray(logits),
        (jnp.asarray(dg1), jnp.asarray(dg2), jnp.asarray(daux)))
    got = ops.route_backward_reference(
        torch.from_numpy(logits), r.dest1, r.dest2, torch.from_numpy(dg1),
        torch.from_numpy(dg2), torch.from_numpy(daux), G, C)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_route_backward_gradcheck_f64():
    """The router's autograd Function (K12's plain version forward, K18's
    backward) in f64, through ``route``: g1, g2 and aux against finite
    differences (gradcheck's fast mode: a random projection of the
    Jacobian), two groups, with drops."""
    rs = np.random.RandomState(11)
    G, g = 2, 12
    logits = rs.standard_normal((G * g, E))
    logits[:, 1] += 1.5
    C = jmoe.Top2GateConfig(num_experts=E, capacity_factor=0.5).capacity(g)
    lg = torch.tensor(logits, dtype=torch.float64, requires_grad=True)

    def routed(lg):
        r = ops.route(lg, G, C, torch.float64)
        return r.g1, r.g2, r.aux

    r = ops.route(lg.detach(), G, C, torch.float64)
    assert (r.dest2 == E * G * C).any()
    assert torch.autograd.gradcheck(routed, (lg,), eps=1e-6, atol=1e-8,
                                    fast_mode=True)


def test_functions_route_gradients_on_the_cpu():
    """Under grad the three ops are autograd Functions: the gather's and
    the combine's backward are their plain versions, the routing's
    weights and aux carry gradients to the logits, and no kernel
    launches on the CPU."""
    rs, logits, _, G, g, C, _ = _routing("two_groups")
    x = torch.tensor(rs.standard_normal((G * g, M)), dtype=torch.float32,
                     requires_grad=True)
    lg = torch.tensor(logits, requires_grad=True)
    counts = [ops.route.launches, ops.gather_rows.launches,
              ops.combine_rows.launches, ops.gather_rows_backward.launches,
              ops.combine_rows_backward.launches, ops.route_backward.launches]
    r = ops.route(lg, G, C, torch.float32)
    assert r.g1.requires_grad and r.aux.requires_grad
    assert not r.dest1.requires_grad and not r.slot_valid.requires_grad
    e_in = ops.gather_rows(x, r.slot_tok, r.slot_valid, r.dest1, r.dest2)
    y = e_in * 2
    out = ops.combine_rows(y, r.g1, r.g2, r.dest1, r.dest2, r.slot_tok)
    cot = torch.from_numpy(rs.standard_normal(out.shape).astype(np.float32))
    (out * cot).sum().add(r.aux.sum()).backward()
    dy, dg1, dg2 = ops.combine_rows_backward_reference(
        cot, y.detach(), r.g1.detach(), r.g2.detach(), r.dest1, r.dest2,
        r.slot_tok)
    assert torch.equal(x.grad, ops.gather_rows_backward_reference(
        dy * 2, r.dest1, r.dest2))
    assert torch.equal(lg.grad, ops.route_backward_reference(
        lg.detach(), r.dest1, r.dest2, dg1, dg2, torch.ones(G), G, C))
    with pytest.raises(ValueError, match="dest1 and dest2"):
        ops.gather_rows(x, r.slot_tok, r.slot_valid)
    with pytest.raises(ValueError, match="slot_tok"):
        ops.combine_rows(y, r.g1, r.g2, r.dest1, r.dest2)
    assert counts == [ops.route.launches, ops.gather_rows.launches,
                      ops.combine_rows.launches,
                      ops.gather_rows_backward.launches,
                      ops.combine_rows_backward.launches,
                      ops.route_backward.launches]

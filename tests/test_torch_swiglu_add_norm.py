"""The plain versions beside K9 (SwiGLU) and K10 (the residual add fused
with RMSNorm) against the JAX package, on the CPU.

Off the card each ``torch.autograd.Function`` runs its plain forward and
its hand-derived backward, the formulas the kernels implement; the tests
hold both against ``jax.vjp`` of the JAX model's own expressions: ``h =
nn.silu(gate) * up`` (kubeflow_tpu/models/llama.py:657) and ``x = x + h``
followed by ``rms_norm(x)`` (:677-678).

Inputs are made from numpy seeds and handed to both sides. Tolerances: f32
1e-6 absolute (with 1e-5 relative: the two frameworks order the sums of
the norm's statistics differently); bf16 one ulp (2^-7 relative) with a
floor of 2^-8 x the largest element, as tests/test_torch_fused_train.py
holds K6 and K7 (K9's bf16 reference is the JAX expression in f32 on the
same bf16 values: see the test). The fused layout of K9 is held bitwise to
its two-tensor form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.ops import norms as jnorms
from kubeflow_tpu_torch.ops import norms
from kubeflow_tpu_torch.ops.swiglu import (
    swiglu,
    swiglu_backward_reference,
    swiglu_fused,
    swiglu_reference,
)

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

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
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=err_msg)


def _both(a: np.ndarray, dtype: str):
    """The same values on both sides: rounded to the dtype in JAX first."""
    jdt, tdt = DT[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


# ---------------------------------------------------------------- K9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_forward_and_backward_match_jax(dtype):
    rs = np.random.RandomState(0)
    jg, tg = _both(rs.randn(3, 5, 64) * 3, dtype)
    ju, tu = _both(rs.randn(3, 5, 64), dtype)
    jd, td = _both(rs.randn(3, 5, 64), dtype)
    # In bf16 the reference is JAX's expression in f32 on the same bf16
    # values: jax.vjp in bf16 rounds inside silu and inside each term of its
    # transpose (two ulps from the exact gradient where they add up), where
    # the port rounds as eager PyTorch does, after the silu and the
    # product, and once more at the silu's incoming gradient.
    f32 = [a.astype(jnp.float32) for a in (jg, ju, jd)]
    want, vjp = jax.vjp(lambda g, u: nn.silu(g) * u, *f32[:2])
    want_dg, want_du = vjp(f32[2])
    want, want_dg, want_du = (a.astype(jg.dtype)
                              for a in (want, want_dg, want_du))
    tg.requires_grad_()
    tu.requires_grad_()
    before = swiglu.fwd_launches, swiglu.bwd_launches
    got = swiglu(tg, tu)
    got.backward(td)
    assert got.dtype == tg.dtype
    _close(got, want, dtype, "h")
    _close(tg.grad, want_dg, dtype, "dgate")
    _close(tu.grad, want_du, dtype, "dup")
    assert (swiglu.fwd_launches, swiglu.bwd_launches) == before  # CPU
    # The Function's backward is the plain backward, bitwise.
    dg, du = swiglu_backward_reference(tg.detach(), tu.detach(), td)
    assert torch.equal(dg, tg.grad) and torch.equal(du, tu.grad)
    assert torch.equal(got, swiglu_reference(tg.detach(), tu.detach()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_fused_layout_is_bitwise_the_two_tensor_form(dtype):
    rs = np.random.RandomState(1)
    _, gu = _both(rs.randn(2, 7, 2, 32) * 2, dtype)
    _, dh = _both(rs.randn(2, 7, 32), dtype)
    gate = gu[..., 0, :].clone().requires_grad_()
    up = gu[..., 1, :].clone().requires_grad_()
    want = swiglu(gate, up)
    want.backward(dh)
    gu = gu.requires_grad_()
    got = swiglu_fused(gu)
    got.backward(dh)
    assert torch.equal(got, want)
    assert gu.grad.shape == gu.shape
    assert torch.equal(gu.grad[..., 0, :], gate.grad)
    assert torch.equal(gu.grad[..., 1, :], up.grad)


def test_swiglu_saves_gate_and_up_only():
    rs = np.random.RandomState(2)
    gate = torch.from_numpy(rs.randn(4, 16).astype(np.float32))
    up = torch.from_numpy(rs.randn(4, 16).astype(np.float32))
    gu = torch.stack([gate, up], dim=-2)
    for args, fn in (((gate, up), swiglu), ((gu,), swiglu_fused)):
        args = [a.clone().requires_grad_() for a in args]
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            fn(*args)
        assert [t.data_ptr() for t in saved] == [a.data_ptr() for a in args]
    with pytest.raises(ValueError, match=r"\[\.\.\., 2, F\]"):
        swiglu_fused(gate)


# ---------------------------------------------------------------- K10


def _jax_add_norm(x, h, w, eps):
    r = x + h
    return r, jnorms.rms_norm(r, w, eps=eps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_forward_and_backward_match_jax(dtype):
    rs = np.random.RandomState(3)
    jx, tx = _both(rs.randn(3, 5, 64) * 2, dtype)
    jh, th = _both(rs.randn(3, 5, 64), dtype)
    jw, tw = _both(1 + 0.1 * rs.randn(64), "float32")
    jdr, tdr = _both(rs.randn(3, 5, 64), dtype)
    jdy, tdy = _both(rs.randn(3, 5, 64), dtype)
    (want_r, want_y), vjp = jax.vjp(
        lambda x, h, w: _jax_add_norm(x, h, w, 1e-5), jx, jh, jw)
    want_dx, want_dh, want_dw = vjp((jdr, jdy))
    for t in (tx, th, tw):
        t.requires_grad_()
    before = norms.add_rms_norm.fwd_launches, norms.add_rms_norm.bwd_launches
    r, y = norms.add_rms_norm(tx, th, tw, eps=1e-5)
    torch.autograd.backward((r, y), (tdr, tdy))
    assert r.dtype == y.dtype == tx.dtype
    # The sum is the eager add's, bitwise (one rounding to the dtype).
    assert torch.equal(r, tx.detach() + th.detach())
    _close(r, want_r, dtype, "r")
    _close(y, want_y, dtype, "y")
    _close(tx.grad, want_dx, dtype, "dx")
    _close(th.grad, want_dh, dtype, "dh")
    _close(tw.grad, want_dw, "float32" if dtype == "float32" else dtype,
           "dw")
    assert (norms.add_rms_norm.fwd_launches,
            norms.add_rms_norm.bwd_launches) == before   # CPU: no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_is_the_unfused_add_then_norm(dtype):
    """The fused Function against the eager add and K6's Function on the
    same inputs: bitwise, whether or not the sum itself has a consumer (the
    final norm's sum has none)."""
    rs = np.random.RandomState(4)
    _, x = _both(rs.randn(6, 32), dtype)
    _, h = _both(rs.randn(6, 32), dtype)
    _, w = _both(1 + 0.1 * rs.randn(32), "float32")
    _, dy = _both(rs.randn(6, 32), dtype)
    for with_sum in (True, False):
        ours = [t.clone().requires_grad_() for t in (x, h, w)]
        r, y = norms.add_rms_norm(*ours, eps=1e-6)
        theirs = [t.clone().requires_grad_() for t in (x, h, w)]
        r2 = theirs[0] + theirs[1]
        y2 = norms.rms_norm(r2, theirs[2], eps=1e-6)
        out, out2 = ((r * 3 + y * dy).sum(), (r2 * 3 + y2 * dy).sum()) \
            if with_sum else ((y * dy).sum(), (y2 * dy).sum())
        out.backward()
        out2.backward()
        assert torch.equal(y, y2)
        for a, b in zip(ours, theirs):
            assert torch.equal(a.grad, b.grad)

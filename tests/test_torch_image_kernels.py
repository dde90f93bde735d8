"""The image slice's element-wise kernels (K19 BatchNorm, K20 LayerNorm,
K21 bias + GELU) and the synthetic image stream, on the CPU, against the
JAX package's flax modules.

On CPU tensors each op runs its plain version through its autograd
Function, which is what the card holds the CUDA kernel against
(tests/test_torch_cuda.py). Inputs are made with numpy and handed to both
sides; gradients on the JAX side come from ``jax.vjp``. Tolerances: f32
outputs and gradients 1e-5 x max |JAX| (the same formulas; the sums run in
another order), the running statistics 1e-6 relative; bf16 2e-2 x max
|JAX| (one bf16 rounding each side, at places that may differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.train.data import SyntheticImageConfig as JaxImageConfig
from kubeflow_tpu.train.data import synthetic_images as jax_synthetic_images
from kubeflow_tpu_torch.ops.batch_norm import batch_norm
from kubeflow_tpu_torch.ops.gelu import bias_gelu
from kubeflow_tpu_torch.ops.layer_norm import layer_norm
from kubeflow_tpu_torch.train.data import SyntheticImageConfig, synthetic_images

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _vjp(fn, args, cot):
    """(fn(*args), the cotangents of args for ``cot``), one jit."""
    def both(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)
    return jax.jit(both)(args, cot)


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (err, tol)


def _t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def test_synthetic_images_bitwise_jax():
    kw = dict(batch_size=3, image_size=16, num_classes=10, seed=5)
    ours = synthetic_images(SyntheticImageConfig(**kw))
    theirs = jax_synthetic_images(JaxImageConfig(**kw))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"inputs", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------- K19


def _bn_case(C=12, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, 5, 3, C) * 2 + rs.randn(C)).astype(np.float32)
    res = rs.randn(2, 5, 3, C).astype(np.float32)
    dy = rs.randn(2, 5, 3, C).astype(np.float32)
    scale = (1 + 0.3 * rs.randn(C)).astype(np.float32)
    bias = (0.2 * rs.randn(C)).astype(np.float32)
    mean = (0.1 * rs.randn(C)).astype(np.float32)
    var = (1 + 0.2 * rs.rand(C)).astype(np.float32)
    return x, res, dy, scale, bias, mean, var


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["plain", "relu", "residual_relu"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(dtype, mode, train):
    """flax BatchNorm (momentum 0.9, eps 1e-5) then ReLU, or relu(y +
    residual): the output, the updated batch_stats (train) or untouched
    ones (eval), and the gradients of x, scale, bias and the residual."""
    jdt, tdt, tol = DTYPES[dtype]
    x, res, dy, scale, bias, mean, var = _bn_case()
    relu, with_res = mode != "plain", mode == "residual_relu"
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                      epsilon=1e-5, dtype=jdt)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def jax_fn(x, scale, bias, res):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        if with_res:
            y = y + res
        return (nn.relu(y) if relu else y), upd["batch_stats"]

    jargs = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
             jnp.asarray(res, jdt))
    zeros = {"mean": jnp.zeros_like(stats["mean"]),
             "var": jnp.zeros_like(stats["var"])}
    (jy, jstats), jgrads = _vjp(jax_fn, jargs, (jnp.asarray(dy, jdt), zeros))

    tx, tres = _t(x, tdt).requires_grad_(), _t(res, tdt).requires_grad_()
    tscale = torch.from_numpy(scale).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    ra_mean, ra_var = torch.from_numpy(mean.copy()), torch.from_numpy(
        var.copy())
    y = batch_norm(tx, tscale, tbias, ra_mean, ra_var, train=train,
                   residual=tres if with_res else None, relu=relu)
    assert y.dtype == tdt and y.shape == x.shape
    _close(y, jy, tol)
    for got, key in ((ra_mean, "mean"), (ra_var, "var")):
        want = np.asarray(jstats[key])
        if train:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
        else:
            assert np.array_equal(got.numpy(), want)
    y.backward(_t(dy, tdt))
    leaves = (tx, tscale, tbias) + ((tres,) if with_res else ())
    for leaf, want in zip(leaves, jgrads):
        _close(leaf.grad, want, tol)
    if not with_res:
        assert tres.grad is None


def test_batch_norm_flax_defaults_are_not_torch_defaults():
    """The three silent ones: momentum is the old value's weight, the
    running variance is the biased one, and epsilon is 1e-5."""
    x, _, _, scale, bias, mean, var = _bn_case(C=4, seed=3)
    ra_mean, ra_var = torch.from_numpy(mean.copy()), torch.from_numpy(
        var.copy())
    batch_norm(torch.from_numpy(x), torch.from_numpy(scale),
               torch.from_numpy(bias), ra_mean, ra_var, train=True)
    xf = x.reshape(-1, 4).astype(np.float64)
    np.testing.assert_allclose(ra_mean.numpy(),
                               0.9 * mean + 0.1 * xf.mean(0), rtol=1e-6)
    np.testing.assert_allclose(ra_var.numpy(),
                               0.9 * var + 0.1 * xf.var(0), rtol=1e-6)
    torch_ra = torch.from_numpy(var.copy())
    torch.nn.functional.batch_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.zeros(4), torch_ra,
        training=True, momentum=0.1)
    assert not np.allclose(torch_ra.numpy(), ra_var.numpy(), rtol=1e-6)


# ---------------------------------------------------------------- K20


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_norm_matches_flax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(1)
    E = 24
    x = (rs.randn(3, 7, E) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(3, 7, E).astype(np.float32)
    scale = (1 + 0.3 * rs.randn(E)).astype(np.float32)
    bias = (0.2 * rs.randn(E)).astype(np.float32)
    ln = nn.LayerNorm(dtype=jdt)

    def jax_fn(x, scale, bias):
        return ln.apply({"params": {"scale": scale, "bias": bias}}, x)

    jy, jgrads = _vjp(jax_fn, (jnp.asarray(x, jdt), jnp.asarray(scale),
                               jnp.asarray(bias)), jnp.asarray(dy, jdt))
    leaves = (_t(x, tdt).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(bias).requires_grad_())
    y = layer_norm(*leaves)
    assert y.dtype == tdt
    _close(y, jy, tol)
    y.backward(_t(dy, tdt))
    for leaf, want in zip(leaves, jgrads):
        _close(leaf.grad, want, tol)


def test_layer_norm_epsilon_is_flax_not_torch():
    """Rows of tiny variance: flax's 1e-6 and torch's 1e-5 part ways."""
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 16).astype(
        np.float32) * 1e-3)
    one, zero = torch.ones(16), torch.zeros(16)
    ours = layer_norm(x, one, zero)
    want = jax.jit(nn.LayerNorm().apply)(
        {"params": {"scale": jnp.ones(16), "bias": jnp.zeros(16)}},
        jnp.asarray(x.numpy()))
    _close(ours, want, 1e-5)
    torch_default = torch.nn.functional.layer_norm(x, (16,))
    assert (ours - torch_default).abs().max() > 1e-2


# ---------------------------------------------------------------- K21


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bias_gelu_matches_jax(dtype):
    """The Dense's bias added in the activation dtype, then nn.gelu (tanh
    form): output and the gradients of the product and the f32 bias."""
    jdt, tdt, tol = DTYPES[dtype]
    rs = np.random.RandomState(4)
    F = 40
    x = (rs.randn(6, 5, F) * 2).astype(np.float32)
    dy = rs.randn(6, 5, F).astype(np.float32)
    b = (0.5 * rs.randn(F)).astype(np.float32)

    def jax_fn(x, b):
        return nn.gelu(x + b.astype(jdt))

    jy, (jdx, jdb) = _vjp(jax_fn, (jnp.asarray(x, jdt), jnp.asarray(b)),
                          jnp.asarray(dy, jdt))
    tx = _t(x, tdt).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = bias_gelu(tx, tb.to(tdt))
    assert y.dtype == tdt
    _close(y, jy, tol)
    y.backward(_t(dy, tdt))
    _close(tx.grad, jdx, tol)
    _close(tb.grad, jdb, tol)
    assert tb.grad.dtype == torch.float32


def test_bias_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 64)
    got = bias_gelu(x, torch.zeros(64))
    want = np.asarray(jax.jit(nn.gelu)(jnp.asarray(x.numpy())))
    _close(got, want, 1e-6)
    exact = torch.nn.functional.gelu(x)
    assert (got - exact).abs().max() > 1e-4

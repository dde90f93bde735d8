"""The port's flash-attention gradients against the JAX package's.

On the CPU the port's autograd Function runs its plain forward and plain
backward (``flash_attention_backward_reference``); the card holds K2
against that same plain backward (tests/test_torch_cuda.py, chip_smoke.py).
The JAX side runs its Pallas kernels in interpret mode at blockable shapes
(block_q = block_kv = 128), as tests/test_flash_attention.py runs them.
f32 inputs; grads atol = rtol = 5e-4, the JAX package's own
flash-vs-reference gradient bound (TestBackward, TestBlockwiseMerge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash_attention as jflash
from kubeflow_tpu_torch.ops import flash_attention as tflash

B, S, H = 2, 256, 4
BLK = dict(block_q=128, block_kv=128)
G_TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(seed, hkv, d, s=S):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, s, H, d).astype(np.float32),
            rs.randn(B, s, hkv, d).astype(np.float32),
            rs.randn(B, s, hkv, d).astype(np.float32),
            rs.randn(B, s, H, d).astype(np.float32))      # the cotangent


def _port_grads(fn, q, k, v):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fn(*leaves).backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(causal, hkv, d):
    q, k, v, co = _inputs(0, hkv, d)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jflash.flash_attention(
            q, k, v, causal=causal, **BLK) * co),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(
        lambda q, k, v: (tflash.flash_attention(q, k, v, causal=causal)
                         * torch.from_numpy(co)).sum(), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **G_TOL,
                                   err_msg=f"d{name}")


def _merged(mod, conv, blk, q, k, v):
    """Two kv halves through flash_attention_lse, merged with their lse:
    the ring-attention composition, whose backward carries dlse."""
    half = S // 2
    o1, l1 = mod.flash_attention_lse(
        *conv(q, k[:, :half], v[:, :half]), causal=True, q_offset=0,
        kv_offset=0, **blk)
    o2, l2 = mod.flash_attention_lse(
        *conv(q, k[:, half:], v[:, half:]), causal=True, q_offset=0,
        kv_offset=half, **blk)
    return mod.merge_attention_blocks(o1, l1, o2, l2)[0]


def test_merge_grads_match_jax():
    q, k, v, co = _inputs(1, 2, 64)
    want = jax.grad(
        lambda q, k, v: jnp.sum(_merged(
            jflash, lambda *a: a, BLK, q, k, v) * co),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(
        lambda q, k, v: (_merged(tflash, lambda *a: a, {}, q, k, v)
                         * torch.from_numpy(co)).sum(), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **G_TOL,
                                   err_msg=f"d{name} through merge")


def test_lse_cotangent_matches_jax():
    # dlse alone (do = 0): the path that folds lse's cotangent into delta.
    q, k, v, _ = _inputs(2, 2, 64)
    cl = np.random.RandomState(3).randn(B, H, S).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jflash.flash_attention_lse(
            q, k, v, causal=True, q_offset=S, kv_offset=0, **BLK)[1] * cl),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(
        lambda q, k, v: (tflash.flash_attention_lse(
            q, k, v, causal=True, q_offset=S, kv_offset=0)[1]
            * torch.from_numpy(cl)).sum(), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **G_TOL,
                                   err_msg=f"d{name} from dlse")


def test_fully_masked_rows_give_zero_grads():
    # kv offset 128: q rows 0..127 see no kv column; kv rows 128.. are seen
    # by no q row.
    q, k, v, co = _inputs(4, 2, 64)
    cl = np.random.RandomState(5).randn(B, H, S).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tflash.flash_attention_lse(*leaves, causal=True, q_offset=0,
                                        kv_offset=torch.tensor(128))
    ((o * torch.from_numpy(co)).sum()
     + (lse * torch.from_numpy(cl)).sum()).backward()
    dq, dk, dv = (t.grad for t in leaves)
    assert torch.all(dq[:, :128] == 0)
    assert torch.all(dk[:, 128:] == 0) and torch.all(dv[:, 128:] == 0)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert dq[:, 128:].abs().max() > 0


@pytest.mark.parametrize("causal,offset", [(False, 0), (True, 0),
                                           (True, -24), (True, 9)])
def test_backward_reference_equals_autograd_of_plain_forward(causal, offset):
    # Exactly the same function: the step-by-step backward against autograd
    # through the plain forward, f32 on both sides (atol 1e-5).
    q, k, v, co = _inputs(6, 2, 16, s=40)
    cl = np.random.RandomState(7).randn(B, H, 40).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tflash.flash_attention_reference(
        *leaves, causal=causal, scale=0.25, offset=offset)
    torch.autograd.backward((o, lse), (torch.from_numpy(co),
                                       torch.from_numpy(cl)))
    want = tflash.flash_attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), o.detach(), lse.detach(),
        torch.from_numpy(co), torch.from_numpy(cl), causal=causal,
        scale=0.25, offset=offset)
    for t, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def test_cpu_backward_counts_no_launch():
    q, k, v, co = _inputs(8, 2, 64, s=16)
    before = (tflash.flash_attention.fwd_launches,
              tflash.flash_attention.bwd_launches)
    _port_grads(lambda q, k, v: tflash.flash_attention(
        q, k, v, causal=True).sum(), q, k, v)
    assert (tflash.flash_attention.fwd_launches,
            tflash.flash_attention.bwd_launches) == before

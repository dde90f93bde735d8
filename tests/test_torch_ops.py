"""The port's plain ops against the JAX package's, on the same numpy inputs.

f32 throughout (the point is the algorithm): atol = rtol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops import norms as jnorms
from kubeflow_tpu.ops import rope as jrope
from kubeflow_tpu_torch.ops import attention, norms, rope

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def test_rms_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 64).astype(np.float32) * 3
    w = rs.randn(64).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_rms_norm_keeps_input_dtype():
    x = torch.randn(3, 8).bfloat16()
    assert norms.rms_norm(x, torch.ones(8)).dtype == torch.bfloat16


def test_rope_matches_jax_including_clamped_positions():
    rs = np.random.RandomState(1)
    D, L = 16, 32
    x = rs.randn(2, 6, 3, D).astype(np.float32)
    # Positions past the table (>= L) clamp to its last row in both.
    pos = np.array([[0, 5, 17, 31, 32, 90], [3, 3, 4, 40, 1, 2]], np.int32)
    jc, js = jrope.rope_frequencies(D, L, theta=500000.0)
    tc, ts = rope.rope_frequencies(D, L, theta=500000.0)
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    want = jrope.apply_rope(jnp.asarray(x), jc, js,
                            positions=jnp.asarray(pos))
    got = rope.apply_rope(torch.from_numpy(x), tc, ts,
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # Default positions are arange.
    np.testing.assert_allclose(
        rope.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        _np(jrope.apply_rope(jnp.asarray(x), jc, js)), **TOL)


def test_masks_match_jax():
    np.testing.assert_array_equal(
        attention.causal_mask(4, 7, q_offset=3).numpy(),
        np.asarray(jattn.causal_mask(4, 7, q_offset=3)))
    seg_q = np.array([[0, 0, 1, 1]])
    seg_kv = np.array([[0, 1, 1, 2, 2]])
    np.testing.assert_array_equal(
        attention.segment_mask(torch.from_numpy(seg_q),
                               torch.from_numpy(seg_kv)).numpy(),
        np.asarray(jattn.segment_mask(jnp.asarray(seg_q),
                                      jnp.asarray(seg_kv))))


def _qkv(seed, B=2, Sq=6, Skv=9, H=4, Hkv=2, D=16):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Sq, H, D).astype(np.float32),
            rs.randn(B, Skv, Hkv, D).astype(np.float32),
            rs.randn(B, Skv, Hkv, D).astype(np.float32))


def _both(q, k, v, **kw):
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **jkw)
    got = attention.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **tkw)
    return got.numpy(), _np(want)


@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(hkv, causal):
    q, k, v = _qkv(2, Hkv=hkv)
    got, want = _both(q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_mha_reference_explicit_mask_and_masked_row(heads):
    q, k, v = _qkv(3)
    rs = np.random.RandomState(4)
    mask = rs.rand(2, heads, 6, 9) > 0.4
    mask[1, :, 2, :] = False                  # fully masked row -> 0
    got, want = _both(q, k, v, mask=mask)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[1, 2] == 0) and not np.isnan(got).any()


def test_mha_reference_int8_scales():
    q, k, v = _qkv(5)
    rs = np.random.RandomState(6)
    k8 = rs.randint(-127, 128, k.shape).astype(np.int8)
    v8 = rs.randint(-127, 128, v.shape).astype(np.int8)
    ks = rs.rand(2, 9, 2, 1).astype(np.float32) / 127
    vs = rs.rand(2, 9, 2, 1).astype(np.float32) / 127
    got, want = _both(q, k8, v8, causal=True, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got, want, **TOL)


def test_mha_reference_bf16_logits_stay_f32():
    # bf16 inputs: the port upcasts before the product, as the JAX
    # einsum's preferred_element_type=f32 keeps logits f32.
    q, k, v = _qkv(7)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jattn.mha_reference(qb, kb, vb, causal=True)
    got = attention.mha_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2e-2,
                               rtol=2e-2)

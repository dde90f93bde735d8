"""The port's flash-attention surface against the JAX package's.

On the CPU the port's wrappers run their plain version (the CUDA kernel is
held against that same plain version on the card: tests/test_torch_cuda.py
and chip_smoke.py). The JAX wrappers run their Pallas kernel in interpret
mode, as tests/test_flash_attention.py runs them. f32 inputs; o atol 2e-5
(the JAX package's own flash-vs-reference bound), lse atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops import flash_attention as jflash
from kubeflow_tpu_torch.ops import flash_attention as tflash

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

B, S, H = 2, 512, 4
BLK = dict(block_q=128, block_kv=128)
O_TOL = dict(atol=2e-5, rtol=2e-5)
L_TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, hkv, d, s=S, sq=None):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, sq or s, H, d).astype(np.float32),
            rs.randn(B, s, hkv, d).astype(np.float32),
            rs.randn(B, s, hkv, d).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(d, hkv, causal):
    q, k, v = _qkv(0, hkv, d)
    want = jflash.flash_attention(*_j(q, k, v), causal=causal, **BLK)
    got = tflash.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)


@pytest.mark.parametrize("q_off,kv_off", [(0, 256), (256, 0), (384, 128)])
def test_flash_attention_lse_offsets_match_jax(q_off, kv_off):
    q, k, v = _qkv(1, 2, 64, s=256)
    want_o, want_l = jflash.flash_attention_lse(
        *_j(q, k, v), causal=True, q_offset=q_off, kv_offset=kv_off, **BLK)
    got_o, got_l = tflash.flash_attention_lse(
        *_t(q, k, v), causal=True, q_offset=q_off,
        kv_offset=torch.tensor(kv_off))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **O_TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **L_TOL)


def test_fully_masked_block_is_zero_and_neg_inf():
    # kv entirely in q's future: every row masked.
    q, k, v = _qkv(2, 2, 64, s=128)
    want_o, want_l = jflash.flash_attention_lse(
        *_j(q, k, v), causal=True, q_offset=0, kv_offset=128, **BLK)
    got_o, got_l = tflash.flash_attention_lse(
        *_t(q, k, v), causal=True, q_offset=0, kv_offset=128)
    assert torch.all(got_o == 0) and torch.all(got_l == tflash.NEG_INF)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("causal", [False, True])
def test_merge_attention_blocks_matches_jax(causal):
    q, k, v = _qkv(3, 2, 64)
    half = S // 2
    outs = {}
    for name, mod, conv, blk in (("jax", jflash, _j, BLK),
                                 ("port", tflash, _t, {})):
        o1, l1 = mod.flash_attention_lse(
            *conv(q, k[:, :half], v[:, :half]), causal=causal,
            q_offset=0, kv_offset=0, **blk)
        o2, l2 = mod.flash_attention_lse(
            *conv(q, k[:, half:], v[:, half:]), causal=causal,
            q_offset=0, kv_offset=half, **blk)
        o, lse = mod.merge_attention_blocks(o1, l1, o2, l2)
        outs[name] = (np.asarray(o), np.asarray(lse))
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], **O_TOL)
    np.testing.assert_allclose(outs["port"][1], outs["jax"][1], **L_TOL)
    full = jattn.mha_reference(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(outs["port"][0], np.asarray(full), **O_TOL)


def test_bucket_32_matches_jax_reference():
    # The JAX wrapper falls back to mha_reference at a 32-token prefill
    # bucket (block_kv % 128 != 0); the port's kernel takes the shape.
    q, k, v = _qkv(4, 2, 128, s=32)
    want = jattn.mha_reference(*_j(q, k, v), causal=True)
    got = tflash.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)


def test_default_blocks_and_env_override(monkeypatch):
    assert tflash.default_blocks(512, 2048) == (512, 1024)
    monkeypatch.setenv("KFTPU_FLASH_BLOCK_KV", "256")
    assert tflash.default_blocks(512, 2048) == jflash.default_blocks(512,
                                                                     2048)
    monkeypatch.setenv("KFTPU_FLASH_BLOCK_Q", "0")
    with pytest.raises(ValueError, match="positive"):
        tflash.default_blocks(512, 512)


def test_cpu_path_counts_no_launch():
    before = tflash.flash_attention.fwd_launches
    tflash.flash_attention(*_t(*_qkv(6, 2, 64, s=16)), causal=True)
    assert tflash.flash_attention.fwd_launches == before

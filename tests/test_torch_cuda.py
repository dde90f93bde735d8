"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: bf16 o atol = rtol = 2e-2 (the JAX package's own bf16 bound,
tests/test_flash_attention.py); lse atol 1e-2 in bf16; f32 o 2e-5 and lse
1e-5; fully masked rows exactly o = 0 and lse = -1e30.
"""

import pytest
import torch

from kubeflow_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_lse,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")


def _qkv(b, sq, skv, h, hkv, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s, n: torch.randn(b, s, n, d, generator=g, device="cuda",  # noqa: E731
                                  dtype=torch.float32).to(dtype)
    return mk(sq, h), mk(skv, hkv), mk(skv, hkv)


def _tol(dtype):
    return (2e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,causal", [
    (32, 32, True), (100, 100, True), (512, 512, True),
    (96, 200, False), (64, 130, True),
])
def test_kernel_matches_plain(dtype, d, sq, skv, causal):
    q, k, v = _qkv(2, sq, skv, 8, 2, d, dtype)
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=causal,
                                     q_offset=skv - sq)
        o_ref, lse_ref = flash_attention_reference(
            q, k, v, causal=causal, scale=d ** -0.5, offset=skv - sq)
    torch.cuda.synchronize()
    otol, ltol = _tol(dtype)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=otol, rtol=otol)
    torch.testing.assert_close(lse, lse_ref, atol=ltol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fully_masked_rows_from_device_offset(dtype):
    q, k, v = _qkv(2, 128, 128, 4, 4, 128, dtype, seed=1)
    kv_off = torch.tensor(64, device="cuda")      # rows 0..63 see nothing
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=True, q_offset=0,
                                     kv_offset=kv_off)
        o_ref, lse_ref = flash_attention_reference(
            q, k, v, causal=True, scale=128 ** -0.5, offset=-64)
    assert torch.all(o[:, :64] == 0)
    assert torch.all(lse[:, :, :64] == NEG_INF)
    otol, ltol = _tol(dtype)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=otol, rtol=otol)
    torch.testing.assert_close(lse, lse_ref, atol=ltol, rtol=0)


def test_strided_views_need_no_copy():
    # q/k/v as views into one fused [B, S, H + 2 Hkv, D] projection.
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(2, 256, 12, 128, generator=g, device="cuda").bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=True)
        o_ref, _ = flash_attention_reference(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            scale=128 ** -0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)


def test_launch_count_and_refusals():
    q, k, v = _qkv(1, 64, 64, 4, 2, 128, torch.bfloat16)
    before = flash_attention.fwd_launches
    with torch.no_grad():
        flash_attention(q, k, v, causal=True)
    assert flash_attention.fwd_launches == before + 1
    with pytest.raises(NotImplementedError, match="K2"):
        flash_attention(q.requires_grad_(), k, v, causal=True)
    q96, k96, v96 = _qkv(1, 64, 64, 4, 2, 96, torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        flash_attention(q96, k96, v96)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16 or f32"):
        flash_attention(q.detach().half(), k.half(), v.half())
    assert flash_attention.fwd_launches == before + 1

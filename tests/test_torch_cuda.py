"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, forward (K1): bf16 o atol = rtol = 2e-2 (the JAX package's own
bf16 bound, tests/test_flash_attention.py); lse atol 1e-2 in bf16; f32 o
2e-5 and lse 1e-5; fully masked rows exactly o = 0 and lse = -1e30.
Backward (K2), each of dq/dk/dv against the plain version on the same
inputs: max |got - plain| <= 2e-2 * max |plain| in bf16 (p and ds are
rounded to bf16 before their products, as in the TPU kernel), 1e-4 in f32;
grads of fully masked rows exactly 0.
Decode attention (K3) against its plain version on the same inputs:
max |got - plain| <= 2e-2 * max |plain| (bf16 output; the kernel rounds
the online softmax's unnormalised weights to bf16, the plain version the
normalised ones); by block table over a paged pool, also bitwise equal
to the dense call over the same rows. The int8-weight product (K4)
against its plain version (the weight dequantized to bf16, then
``F.linear``, which sums in f32 as the kernel does): max |got - plain|
<= 1e-2 * max |plain|. The
serving engine's CUDA graphs against its eager path (``_eager=True``) on a
small bf16 model: greedy tokens equal; the paged engine's graphs give
the dense engine's tokens; the chunked prefill's graph also leaves the
eager path's cache rows, bitwise, and one graph a sampling variant serves
every slot and start. The training step's fused kernels: K5 (the
optimizer) bitwise equal to its plain update given the same norm, the
norm within relative 1e-6 of an f64 sum; K6 (RMSNorm) and K7 (RoPE) within
one ulp of their plain versions (K7 also bitwise); K8 (cross-entropy) the
loss within relative 1e-5, dlogits within 2e-2 x max |plain|. K11 (the
adafactor update) against its plain version: moments (v_row, v_col, v)
within 1e-6 relative of the plain version in f64, params within one bf16
ulp of max(|plain|, 2^-8 x max |plain|) of it in f32 (the means and block
RMS are summed in another order; given the same sums the two agree
bitwise), two calls bitwise equal, the norm it computes within 1e-6
relative of K5's. K6 and K10's rows forward (the serving decode's rows)
as their present forward: the sum bitwise, y within one bf16 ulp. K7's
staged-decode mode bitwise its plain version (q, and the staging tensors
whole); K4's SwiGLU epilogue bitwise K4's grouped gate/up launch followed
by K9 at the same K split, and within K4's tolerance of its plain
composition. The MoE dispatch (K12-K14) bitwise its plain versions: the
routing's integer outputs equal and its weights, slot flags and aux loss
bitwise, the gather and the combine bitwise; a small Mixtral engine's
graphs give its eager path's greedy tokens.
"""

import pytest
import torch

from kubeflow_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_backward_reference,
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
    bwd_before = flash_attention.bwd_launches
    qg = q.detach().requires_grad_()
    flash_attention(qg, k, v, causal=True).float().sum().backward()
    assert flash_attention.bwd_launches == bwd_before + 1
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    before += 1          # the forward of that backward pass
    q96, k96, v96 = _qkv(1, 64, 64, 4, 2, 96, torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="head_dim"):
        flash_attention(q96, k96, v96)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16 or f32"):
        flash_attention(q.detach().half(), k.half(), v.half())
    assert flash_attention.fwd_launches == before + 1


# The bf16 kernel's tiles: Sq <= 64 takes 64-row q and kv tiles (one
# consumer warpgroup), longer q 128-row tiles (two); k/v arrive by TMA, whose
# zero fill pads the ragged edges the kernel then masks.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,causal,offset", [
    (200, 200, True, 0), (1000, 1000, True, 0), (64, 130, True, 66),
    (96, 200, False, 0), (128, 384, True, 256), (300, 700, True, 100),
    (256, 256, True, -100), (1, 1, True, 0), (17, 300, True, 283),
    (48, 48, True, 0), (64, 64, False, 0), (40, 1000, False, 0),
])
def test_forward_tiles_match_plain(d, sq, skv, causal, offset):
    q, k, v = _qkv(2, sq, skv, 8, 2, d, torch.bfloat16, seed=8)
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=causal, q_offset=offset)
        o_ref, lse_ref = flash_attention_reference(
            q, k, v, causal=causal, scale=d ** -0.5, offset=offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-2, rtol=0)
    if causal and offset < 0:
        assert torch.all(o[:, :-offset] == 0)
        assert torch.all(lse[:, :, :-offset] == NEG_INF)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("sq", [32, 512])
def test_forward_query_groups(group, sq):
    q, k, v = _qkv(2, sq, sq, 8, 8 // group, 128, torch.bfloat16, seed=9)
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=True)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal=True,
                                                   scale=128 ** -0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("sq,kv_off", [(48, 40), (640, 300)])
def test_forward_masked_rows_from_device_offset(sq, kv_off):
    q, k, v = _qkv(2, sq, sq, 4, 2, 128, torch.bfloat16, seed=10)
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=True, q_offset=0,
                                     kv_offset=torch.tensor(kv_off,
                                                            device="cuda"))
        o_ref, lse_ref = flash_attention_reference(
            q, k, v, causal=True, scale=128 ** -0.5, offset=-kv_off)
    assert torch.all(o[:, :kv_off] == 0)
    assert torch.all(lse[:, :, :kv_off] == NEG_INF)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("s", [48, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_forward_strided_views_of_fused_projection(s, d):
    # q/k/v as views into one fused [B, S, H + 2 Hkv, D] projection; the
    # tensor maps read them through their strides.
    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn(2, s, 16, d, generator=g, device="cuda").bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    with torch.no_grad():
        o, lse = flash_attention_lse(q, k, v, causal=True)
        o_ref, lse_ref = flash_attention_reference(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            scale=d ** -0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-2, rtol=0)


def test_forward_refuses_misaligned_stride():
    # Rows 132 elements apart: not a multiple of 16 bytes, so no tensor map.
    q, k, v = _qkv(1, 64, 64, 4, 2, 128, torch.bfloat16)
    wide = torch.zeros(1, 64, 4, 132, device="cuda", dtype=torch.bfloat16)
    wide[..., :128] = q
    before = flash_attention.fwd_launches
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(wide[..., :128], k, v, causal=True)
    assert flash_attention.fwd_launches == before


def _bwd_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def _check_grads(got, want, dtype):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype, name
        err = (g.float() - w.float()).abs().max().item()
        ref = w.float().abs().max().item()
        assert err <= _bwd_tol(dtype) * ref, f"{name}: {err} vs max {ref}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,causal", [
    (64, 64, True), (100, 100, True), (512, 512, True),
    (96, 200, False), (64, 130, True),
])
def test_backward_kernel_matches_plain(dtype, d, sq, skv, causal):
    q, k, v = _qkv(2, sq, skv, 8, 2, d, dtype, seed=3)
    g = torch.Generator(device="cuda").manual_seed(4)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    dlse = torch.randn(2, 8, sq, generator=g, device="cuda")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = flash_attention.bwd_launches
    o, lse = flash_attention_lse(*leaves, causal=causal, q_offset=skv - sq)
    torch.autograd.backward((o, lse), (do, dlse))
    assert flash_attention.bwd_launches == before + 1
    want = flash_attention_backward_reference(
        q, k, v, o.detach(), lse.detach(), do, dlse, causal=causal,
        scale=d ** -0.5, offset=skv - sq)
    torch.cuda.synchronize()
    _check_grads([t.grad for t in leaves], want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_masked_rows_from_device_offset(dtype):
    q, k, v = _qkv(2, 128, 128, 4, 2, 128, dtype, seed=5)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kv_off = torch.tensor(64, device="cuda")      # rows 0..63 see nothing
    o, lse = flash_attention_lse(*leaves, causal=True, q_offset=0,
                                 kv_offset=kv_off)
    g = torch.Generator(device="cuda").manual_seed(6)
    do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
    dlse = torch.randn(lse.shape, generator=g, device="cuda")
    torch.autograd.backward((o, lse), (do, dlse))
    assert torch.all(leaves[0].grad[:, :64] == 0)
    # kv rows 64.. are seen by no q row at this offset.
    assert torch.all(leaves[1].grad[:, 64:] == 0)
    assert torch.all(leaves[2].grad[:, 64:] == 0)
    want = flash_attention_backward_reference(
        q, k, v, o.detach(), lse.detach(), do, dlse, causal=True,
        scale=128 ** -0.5, offset=-64)
    _check_grads([t.grad for t in leaves], want, dtype)


def test_backward_strided_views():
    # q/k/v as views into one fused [B, S, H + 2 Hkv, D] projection.
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn(2, 256, 12, 128, generator=g, device="cuda").bfloat16()
    qkv.requires_grad_()
    o = flash_attention(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:],
                        causal=True)
    do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
    o.backward(do)
    q, k, v = (qkv.detach()[:, :, a:b].contiguous()
               for a, b in ((0, 8), (8, 10), (10, 12)))
    o_ref, lse_ref = flash_attention_reference(q, k, v, causal=True,
                                               scale=128 ** -0.5)
    want = flash_attention_backward_reference(
        q, k, v, o.detach(), lse_ref, do, causal=True, scale=128 ** -0.5)
    got = (qkv.grad[:, :, :8], qkv.grad[:, :, 8:10], qkv.grad[:, :, 10:])
    _check_grads(got, want, torch.bfloat16)


# The bf16 backward's tiles: the dk/dv kernel takes 128-row kv tiles (two
# consumer warpgroups of 64) and streams 64-row q tiles over the query
# group; the dq kernel takes 64-row q tiles and streams 64-row kv tiles.
# TMA's zero fill pads the ragged edges, whose rows the stores clip.
def _bwd_case(b, sq, skv, h, hkv, d, causal, q_off, kv_off=0, seed=12):
    q, k, v = _qkv(b, sq, skv, h, hkv, d, torch.bfloat16, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    dlse = torch.randn(b, h, sq, generator=g, device="cuda")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o, lse = flash_attention_lse(*leaves, causal=causal, q_offset=q_off,
                                 kv_offset=kv_off)
    torch.autograd.backward((o, lse), (do, dlse))
    off = q_off - (kv_off if isinstance(kv_off, int) else int(kv_off))
    want = flash_attention_backward_reference(
        q, k, v, o.detach(), lse.detach(), do, dlse, causal=causal,
        scale=d ** -0.5, offset=off)
    torch.cuda.synchronize()
    got = [t.grad for t in leaves]
    _check_grads(got, want, torch.bfloat16)
    return got


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,causal,offset", [
    (77, 77, True, 0), (129, 129, True, 0), (1000, 1000, True, 0),
    (77, 300, True, 223), (300, 77, True, 0), (129, 1000, False, 0),
    (1000, 129, False, 0), (200, 200, True, -100), (64, 200, True, 136),
    (1, 1, True, 0), (48, 48, True, 0), (256, 384, True, 128),
])
def test_backward_tiles_match_plain(d, sq, skv, causal, offset):
    got = _bwd_case(2, sq, skv, 8, 2, d, causal, offset)
    if causal and offset < 0:
        assert torch.all(got[0][:, :-offset] == 0)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_query_groups(group, d):
    _bwd_case(2, 333, 333, 8, 8 // group, d, True, 0, seed=14)


@pytest.mark.parametrize("sq,kv_off", [(640, 300), (129, 100)])
def test_backward_masked_tiles_from_device_offset(sq, kv_off):
    # q rows < kv_off see no kv column (whole 64-row q tiles at 640), and
    # kv rows >= sq - kv_off are seen by no q row (whole 128-row kv tiles
    # at 640): their grads are exactly 0.
    dq, dk, dv = _bwd_case(2, sq, sq, 4, 2, 128, True, 0,
                           kv_off=torch.tensor(kv_off, device="cuda"),
                           seed=16)
    assert torch.all(dq[:, :kv_off] == 0)
    assert torch.all(dk[:, sq - kv_off:] == 0)
    assert torch.all(dv[:, sq - kv_off:] == 0)


@pytest.mark.parametrize("s", [48, 1000])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_strided_views_of_fused_projection(s, d):
    # q/k/v as views into one fused [B, S, H + 2 Hkv, D] projection; the
    # tensor maps read them, and the grads land in the fused grad, through
    # their strides.
    g = torch.Generator(device="cuda").manual_seed(18)
    qkv = torch.randn(2, s, 16, d, generator=g, device="cuda").bfloat16()
    qkv.requires_grad_()
    o = flash_attention(qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:],
                        causal=True)
    do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
    o.backward(do)
    q, k, v = (qkv.detach()[:, :, a:b].contiguous()
               for a, b in ((0, 8), (8, 12), (12, 16)))
    _, lse_ref = flash_attention_reference(q, k, v, causal=True,
                                           scale=d ** -0.5)
    want = flash_attention_backward_reference(
        q, k, v, o.detach(), lse_ref, do, causal=True, scale=d ** -0.5)
    got = (qkv.grad[:, :, :8], qkv.grad[:, :, 8:12], qkv.grad[:, :, 12:])
    _check_grads(got, want, torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
def test_backward_is_deterministic(d):
    # No atomics: every grad element is written by one block, so two calls
    # on the same inputs agree bit for bit.
    q, k, v = _qkv(2, 1000, 1000, 16, 8, d, torch.bfloat16, seed=20)
    g = torch.Generator(device="cuda").manual_seed(21)
    do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, causal=True)
    first = torch.autograd.grad(o, leaves, do, retain_graph=True)
    second = torch.autograd.grad(o, leaves, do)
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------- K3

DEC_L, DEC_C = 1024, 8
# Live lengths the kernel must take: one row, ragged, nearly and exactly
# full, and an idle slot whose index ran past the cache.
DEC_LENGTHS = {"1": 1, "17": 17, "1000": 1000, "Lm1": DEC_L - 1,
               "idle": 3 * DEC_L}


def _decode_inputs(b, g, d, cache, seed=0, hkv=2):
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q = rnd(b, 1, hkv * g, d)
    k, v = rnd(b, DEC_L, hkv, d), rnd(b, DEC_L, hkv, d)
    scales = {}
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        scales = {"k_scale": ks, "v_scale": vs}
    stage = {"stage_key": rnd(b, DEC_C, hkv, d),
             "stage_value": rnd(b, DEC_C, hkv, d)}
    return q, k, v, scales, stage


def _check_decode(got, want):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= 2e-2 * ref, (err, ref)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("length", sorted(DEC_LENGTHS))
def test_decode_kernel_matches_plain(length, b, g, d, cache):
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, scales, _ = _decode_inputs(b, g, d, cache)
    lens = [DEC_LENGTHS[length], 1, 17, 1000, DEC_L - 1, 3 * DEC_L, 5,
            512][:b]
    idx = torch.tensor(lens, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        got = decode_attention(q, k, v, idx, **scales)
        want = decode_attention_reference(q, k, v, idx, **scales)
    _check_decode(got, want)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("stage_step", range(DEC_C))
def test_decode_kernel_staged_matches_plain(stage_step, cache):
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, scales, stage = _decode_inputs(8, 4, 128, cache, seed=1,
                                            hkv=8)
    # Flushed lengths: none yet, ragged, full, and an idle slot.
    idx = torch.tensor([0, 1, 17, 300, 1000, DEC_L - 1, DEC_L, 3 * DEC_L],
                       dtype=torch.int32, device="cuda")
    with torch.no_grad():
        got = decode_attention(q, k, v, idx, stage_step=stage_step,
                               **scales, **stage)
        want = decode_attention_reference(q, k, v, idx,
                                          stage_step=stage_step, **scales,
                                          **stage)
    _check_decode(got, want)


def test_decode_kernel_counts_and_refusals():
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, _, _ = _decode_inputs(2, 4, 128, "bf16")
    idx = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    with torch.no_grad():
        decode_attention(q, k, v, idx)
        assert decode_attention.launches == before + 1
        with pytest.raises(ValueError, match="bf16 q"):
            decode_attention(q.float(), k, v, idx)
        with pytest.raises(ValueError, match="one query row"):
            decode_attention(torch.cat([q, q], 1), k, v, idx)
        with pytest.raises(ValueError, match="k_scale"):
            decode_attention(q, k.to(torch.int8), v.to(torch.int8), idx)
    assert decode_attention.launches == before + 1


def test_decode_kernel_replays_in_a_graph_at_every_length():
    """One capture serves every length: the lengths are device data."""
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, _, _ = _decode_inputs(8, 4, 128, "bf16", seed=2, hkv=8)
    idx = torch.ones(8, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        decode_attention(q, k, v, idx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), torch.no_grad():
        out = decode_attention(q, k, v, idx)
    for lens in ([1] * 8, [5, 64, 65, 700, 1023, 1024, 1, 3000]):
        idx.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        _check_decode(out, decode_attention_reference(q, k, v, idx))


def _decode_pair(q, k, v, idx, scales, stage=None, stage_step=None):
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    extra = {} if stage is None else dict(stage, stage_step=stage_step)
    with torch.no_grad():
        got = decode_attention(q, k, v, idx, **scales, **extra)
        want = decode_attention_reference(q, k, v, idx, **scales, **extra)
    return got, want


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_decode_kernel_is_deterministic(cache, staged):
    """The merge order is fixed and nothing is added atomically: two calls
    on the same inputs are bitwise equal."""
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, scales, stage = _decode_inputs(8, 4, 128, cache, seed=3, hkv=8)
    idx = torch.tensor([0, 15, 129, 300, 777, 1000, DEC_L, 3 * DEC_L],
                       dtype=torch.int32, device="cuda")
    extra = dict(stage, stage_step=DEC_C - 1) if staged else {}
    with torch.no_grad():
        first = decode_attention(q, k, v, idx, **scales, **extra)
        second = decode_attention(q, k, v, idx, **scales, **extra)
    assert torch.equal(first, second)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("length", [15, 16, 17, 127, 128, 129, 143, 144,
                                    145, 1008, 1009])
def test_decode_kernel_at_block_share_boundaries(length, cache):
    """Lengths at the edges of the 16-row chunks and of the blocks' shares
    (at L = 1024 a cluster of 8 blocks takes one chunk each at 128 rows,
    and one block takes a second from 129)."""
    q, k, v, scales, stage = _decode_inputs(4, 4, 128, cache, seed=4, hkv=2)
    idx = torch.tensor([length, length - 1, length + 1, 2 * length],
                       dtype=torch.int32, device="cuda")
    _check_decode(*_decode_pair(q, k, v, idx, scales))
    _check_decode(*_decode_pair(q, k, v, idx, scales, stage, DEC_C - 1))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_decode_kernel_all_slots_empty_gives_zero(cache):
    q, k, v, scales, _ = _decode_inputs(8, 4, 128, cache, seed=5, hkv=8)
    idx = torch.zeros(8, dtype=torch.int32, device="cuda")
    got, want = _decode_pair(q, k, v, idx, scales)
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(want, torch.zeros_like(want))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("stage_step", [0, DEC_C - 1])
def test_decode_kernel_staged_with_an_empty_slot(stage_step, cache):
    """A slot with no flushed row still attends its staging rows."""
    q, k, v, scales, stage = _decode_inputs(8, 4, 128, cache, seed=6, hkv=8)
    idx = torch.tensor([0, 36, 46, 116, 136, 216, 266, 516],
                       dtype=torch.int32, device="cuda")
    got, want = _decode_pair(q, k, v, idx, scales, stage, stage_step)
    _check_decode(got, want)
    assert got[0].abs().max() > 0


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [2, 8])
def test_decode_kernel_query_groups(g, d, cache, staged):
    q, k, v, scales, stage = _decode_inputs(4, g, d, cache, seed=7, hkv=2)
    idx = torch.tensor([1, 129, 700, DEC_L], dtype=torch.int32,
                       device="cuda")
    if staged:
        _check_decode(*_decode_pair(q, k, v, idx, scales, stage, 3))
    else:
        _check_decode(*_decode_pair(q, k, v, idx, scales))


LONG_L = 8192       # llama3-8b's max_seq_len


def _long_inputs(cache, seed):
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q = rnd(8, 1, 32, 128)
    k, v = rnd(8, LONG_L, 8, 128), rnd(8, LONG_L, 8, 128)
    scales = {}
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        scales = {"k_scale": ks, "v_scale": vs}
    stage = {"stage_key": rnd(8, DEC_C, 8, 128),
             "stage_value": rnd(8, DEC_C, 8, 128)}
    return q, k, v, scales, stage


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_decode_kernel_long_cache(cache):
    """L = 8192: a block walks up to 1024 rows through its ring."""
    q, k, v, scales, stage = _long_inputs(cache, seed=8)
    idx = torch.tensor([1, 1024, 2049, 4096, 5000, 8191, LONG_L,
                        3 * LONG_L], dtype=torch.int32, device="cuda")
    _check_decode(*_decode_pair(q, k, v, idx, scales))
    _check_decode(*_decode_pair(q, k, v, idx, scales, stage, DEC_C - 1))


def test_decode_kernel_long_cache_graph_replays_at_every_length():
    """One capture at L = 8192 serves every length."""
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, _, stage = _long_inputs("bf16", seed=9)
    idx = torch.ones(8, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        decode_attention(q, k, v, idx, **stage, stage_step=2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), torch.no_grad():
        out = decode_attention(q, k, v, idx, **stage, stage_step=2)
    for lens in ([0] * 8, [1] * 8, [17, 128, 129, 1024, 4097, 8000, 8192,
                                    30000], [8192] * 8):
        idx.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        with torch.no_grad():
            want = decode_attention_reference(q, k, v, idx, **stage,
                                              stage_step=2)
        _check_decode(out, want)


# ------------------------------------------------- K3 by block table

PAGE_ROWS, PAGED_BLOCKS = 16, 16          # a logical length of 256 rows
# Slots: one row, ragged, a full table, an idle slot past it.
PAGED_LENGTHS = [1, 17, 200, PAGE_ROWS * PAGED_BLOCKS, 40, 3 * 256, 129, 0]


def _pool_inputs(b, g, d, cache, seed=0, hkv=2, bs=PAGE_ROWS,
                 max_blocks=PAGED_BLOCKS):
    """q, a pool [P + 1, bs, hkv, d] (int8 with scale pools), tables that
    are a random permutation of the pool's pages with slot 1's first page
    also slot 0's (a shared page), and staging rows."""
    from kubeflow_tpu_torch.models.llama import quantize_kv_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    pages = b * max_blocks + 3
    q = rnd(b, 1, hkv * g, d)
    k, v = rnd(pages + 1, bs, hkv, d), rnd(pages + 1, bs, hkv, d)
    scales = {}
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        scales = {"k_scale": ks, "v_scale": vs}
    tables = torch.randperm(pages, generator=gen, device="cuda")[
        :b * max_blocks].view(b, max_blocks).int()
    if b > 1:
        tables[1, 0] = tables[0, 0]
    stage = {"stage_key": rnd(b, DEC_C, hkv, d),
             "stage_value": rnd(b, DEC_C, hkv, d)}
    return q, k, v, scales, tables.contiguous(), stage


def _paged_triple(q, k, v, idx, scales, tables, bs, extra):
    """K3 by table, K3 dense over the gathered rows, the plain version."""
    from kubeflow_tpu_torch.ops.attention import decode_attention_reference
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.paged_attention import gather_cache

    dk, dv, dks, dvs = gather_cache(tables, bs, k, v, scales.get("k_scale"),
                                    scales.get("v_scale"))
    dense_scales = {} if dks is None else {"k_scale": dks, "v_scale": dvs}
    with torch.no_grad():
        got = decode_attention(q, k, v, idx, **scales, **extra,
                               block_tables=tables, block_size=bs)
        dense = decode_attention(q, dk, dv, idx, **dense_scales, **extra)
        want = decode_attention_reference(q, dk, dv, idx, **dense_scales,
                                          **extra)
    return got, dense, want


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_decode_kernel_by_table_matches_plain_and_dense(g, d, cache, staged):
    """A shuffled table with a shared page: within the bound of the plain
    version, and bitwise the dense call over the same rows (the same
    split, chunks and merge)."""
    q, k, v, scales, tables, stage = _pool_inputs(8, g, d, cache, seed=5)
    idx = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")
    extra = dict(stage, stage_step=DEC_C - 1) if staged else {}
    got, dense, want = _paged_triple(q, k, v, idx, scales, tables,
                                     PAGE_ROWS, extra)
    assert torch.equal(got, dense)
    _check_decode(got, want)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("bs", [32, 48])
def test_decode_kernel_by_table_at_larger_pages(bs, cache):
    """Pages of several 16-row chunks (48 rows: not a power of two)."""
    q, k, v, scales, tables, stage = _pool_inputs(4, 4, 128, cache, seed=6,
                                                  bs=bs, max_blocks=6)
    idx = torch.tensor([1, 47, 49, 6 * bs], dtype=torch.int32,
                       device="cuda")
    got, dense, want = _paged_triple(q, k, v, idx, scales, tables, bs,
                                     dict(stage, stage_step=3))
    assert torch.equal(got, dense)
    _check_decode(got, want)


def test_decode_kernel_by_table_refuses_pages_under_16_rows():
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    q, k, v, _, tables, _ = _pool_inputs(2, 4, 128, "bf16", bs=8)
    idx = torch.tensor([3, 9], dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    with torch.no_grad(), pytest.raises(ValueError, match="multiple of 16"):
        decode_attention(q, k, v, idx, block_tables=tables, block_size=8)
    q, k, v, _, tables, _ = _pool_inputs(2, 4, 128, "bf16")
    with torch.no_grad(), pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, idx, block_tables=tables.long(),
                         block_size=PAGE_ROWS)
    assert decode_attention.launches == before


def test_decode_kernel_by_table_graph_serves_every_table():
    """One capture serves any table and length: both are device data."""
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention

    q, k, v, scales, tables, stage = _pool_inputs(8, 4, 128, "int8", seed=7,
                                                  hkv=8)
    idx = torch.ones(8, dtype=torch.int32, device="cuda")
    kw = dict(scales, **stage, stage_step=2, block_tables=tables,
              block_size=PAGE_ROWS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        decode_attention(q, k, v, idx, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), torch.no_grad():
        out = decode_attention(q, k, v, idx, **kw)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for lens in ([1] * 8, PAGED_LENGTHS):
        tables.copy_(torch.randperm(k.shape[0] - 1, generator=gen,
                                    device="cuda")[:tables.numel()]
                     .view_as(tables))
        idx.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        with torch.no_grad():
            want = paged_decode_attention(
                q, k, v, tables, (idx.long() + 2)[:, None], PAGE_ROWS,
                key_scale_pool=scales["k_scale"],
                value_scale_pool=scales["v_scale"], **stage, stage_step=2)
        _check_decode(out, want)


# ------------------------------------------------- the engine's graphs

def _small_engine(option="staged", eager=False, **kw):
    """llama of K1/K3's head_dim on the card, random bf16 weights from a
    seed; the model options of the serving slice."""
    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    chunk = kw.pop("decode_chunk", 4)
    paged = kw.pop("paged", 0)             # pool blocks of 16 rows
    model_kw = {"staged": {"decode_staging": chunk},
                "int8_staged": {"decode_staging": chunk,
                                "kv_cache_dtype": "int8"},
                "unstaged": {}, "int8": {"kv_cache_dtype": "int8"}}[option]
    if paged:
        model_kw = dict(model_kw, paged_kv_blocks=paged)
        kw.update(kv_blocks=paged, kv_block_size=16)
    cfg = LlamaConfig.tiny(vocab_size=512, embed_dim=256, num_heads=4,
                           num_kv_heads=2, head_dim=64, mlp_dim=512,
                           max_seq_len=256, **model_kw)
    with torch.device("cuda"):
        model = Llama(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    scfg = dict(max_batch=4, max_len=256, prefill_buckets=(16, 32),
                decode_chunk=chunk, pipeline_depth=2)
    scfg.update(kw)
    return ServingEngine(model, ServingConfig(**scfg), device="cuda",
                         registry=MetricsRegistry(), _eager=eager)


# More prompts than slots, two buckets, and one past the largest bucket
# (chunked prefill): admissions land between chained chunks.
ENGINE_PROMPTS = [(list(range(3, 12)), 20), (list(range(40, 70)), 13),
                  ([7] * 5, 30), (list(range(100, 150)), 9),
                  ([2, 9, 4], 17), (list(range(200, 220)), 11)]


def _serve(eng, prompts=ENGINE_PROMPTS, **req):
    rids = [eng.submit(p, max_new_tokens=n, **req) for p, n in prompts]
    eng.run()
    return [eng.result(r).tokens for r in rids]


@pytest.mark.parametrize("option", ["unstaged", "staged", "int8_staged"])
def test_engine_graph_tokens_equal_eager(option):
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    with torch.no_grad():
        want = _serve(_small_engine(option, eager=True))
        eng = _small_engine(option)
        eng.warmup(16)
        k1, k3 = flash_attention.fwd_launches, decode_attention.launches
        eng.prefill_dispatches = eng.extend_dispatches = 0
        eng.decode_dispatches = 0
        got = _serve(eng)
    assert got == want
    # The 50-token prompt's chunked prefill replays the extend's graph.
    assert {key[0] for key in eng._graphs} == {"decode", "prefill", "extend"}
    # Replays count their captured launches: K1 once per layer per
    # prefill or extend dispatch, K3 once per layer per decode step.
    layers = eng.model.cfg.num_layers
    assert flash_attention.fwd_launches - k1 == layers * (
        eng.prefill_dispatches + eng.extend_dispatches)
    assert decode_attention.launches - k3 == (
        layers * eng.cfg.decode_chunk * eng.decode_dispatches)


def test_chained_outputs_survive_the_next_replay():
    import numpy as np

    outs = {}
    for eager in (True, False):
        eng = _small_engine("staged", eager=eager)
        with torch.no_grad():
            for p, n in ENGINE_PROMPTS[:4]:
                eng.submit(p, max_new_tokens=n)
            eng._admit()
            first = eng._dispatch_decode(None)
            second = eng._dispatch_decode(first)   # replays the same graph
            third = eng._dispatch_decode(second)
            outs[eager] = [np.asarray(d.out.cpu())
                           for d in (first, second, third)]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs[False][0], outs[False][1])


def test_sampled_replays_differ_and_reproduce_by_seed():
    prompts = [([5, 6, 7], 24), ([9, 8], 24)]
    runs = []
    for _ in range(2):
        eng = _small_engine("staged")
        with torch.no_grad():
            runs.append([_serve(eng, prompts, temperature=1.0),
                         _serve(eng, prompts, temperature=1.0, top_k=50)])
            runs[-1].append(_serve(eng, prompts, temperature=1.0))
    assert ("decode", "plain") in eng._graphs
    assert ("decode", "restricted") in eng._graphs
    assert runs[0] == runs[1]              # the engine's seed reproduces
    assert runs[0][0] != runs[0][2]        # later replays draw new noise


def test_card_serve_never_runs_the_plain_attention(monkeypatch):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops import attention, decode_attention

    def refuse(*args, **kwargs):
        raise AssertionError("the card's serve path ran a plain attention")

    monkeypatch.setattr(decode_attention, "decode_attention_reference",
                        refuse)
    monkeypatch.setattr(attention, "mha_reference", refuse)
    monkeypatch.setattr(llama, "mha_reference", refuse)
    for option in ("unstaged", "int8", "int8_staged"):
        for eager in (True, False):
            with torch.no_grad():
                toks = _serve(_small_engine(option, eager=eager))
            assert [len(t) for t in toks] == [n for _, n in ENGINE_PROMPTS]


# The engine prompts with the first two repeated right after them: the
# repeats share their holders' pages, and each pair's first decode write
# forks the shared partial tail page.
PAGED_PROMPTS = (ENGINE_PROMPTS[:1] + [(list(range(3, 12)), 15)]
                 + ENGINE_PROMPTS[1:2] + [(list(range(40, 70)), 6)]
                 + ENGINE_PROMPTS[2:])


@pytest.mark.parametrize("option", ["unstaged", "staged", "int8_staged"])
def test_engine_paged_graph_tokens_equal_dense(option):
    """The paged engine's graphs (K3 by table, the pool's writes and COW
    copies between replays) give the dense engine's tokens, and its eager
    path's."""
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    with torch.no_grad():
        dense = _serve(_small_engine(option), PAGED_PROMPTS)
        eager = _serve(_small_engine(option, eager=True, paged=64),
                       PAGED_PROMPTS)
        eng = _small_engine(option, paged=64)
        eng.warmup(16)
        k3 = decode_attention.launches
        eng.decode_dispatches = 0
        got = _serve(eng, PAGED_PROMPTS)
    assert got == dense == eager
    assert eng.blocks.shared_refs_total > 0 and eng.cow_copies > 0
    eng.blocks.check_conservation()
    assert eng.blocks.blocks_live == 0
    assert decode_attention.launches - k3 == (
        eng.model.cfg.num_layers * eng.cfg.decode_chunk
        * eng.decode_dispatches)


# A holder past the largest bucket (32): chunks at 0 and 5 (slid back);
# then a 50-token prompt opening with the holder's two whole 16-row pages
# (paged: shared, write_from 32): chunks at 0 and 18.
EXTEND_HOLDER = list(range(3, 40))
EXTEND_SHARER = EXTEND_HOLDER[:32] + list(range(100, 118))
EXTEND_OPTIONS = {
    "bf16": ("unstaged", {}),
    "int8_kv": ("int8_staged", {}),
    "int8_weights": ("staged", {"quantize": "int8",
                                "quantize_min_size": 1024}),
    "paged": ("int8_staged", {"paged": 64}),
}


def _slot_rows(eng, slot, n):
    """Every layer's first ``n`` cache rows of ``slot`` (k/v and the int8
    scales; a paged engine's gathered through the slot's device table)
    and its cache_index."""
    from kubeflow_tpu_torch.ops.paged_attention import gather_kv_pages
    from kubeflow_tpu_torch.serving.engine import _ROW_LEAVES

    rows = []
    for layer in eng._cache:
        got = {"cache_index": layer["cache_index"][slot].clone()}
        for name in _ROW_LEAVES:
            if name not in layer:
                continue
            if eng._paged:
                table = eng._tables_device()[slot:slot + 1]
                got[name] = gather_kv_pages(layer[name], table,
                                            eng.cfg.kv_block_size)[0, :n]
            else:
                got[name] = layer[name][slot, :n].clone()
        rows.append(got)
    return rows


def _extend_trace(eng):
    """A short prompt decoding on slot 0, the holder's chunked prefill on
    slot 1 beside it, then the sharer's on slot 2: the tokens, and both
    long prompts' cache rows right after their extends."""
    rids, rows = [eng.submit([5, 6, 7], max_new_tokens=24)], []
    eng.step()
    for prompt, slot in ((EXTEND_HOLDER, 1), (EXTEND_SHARER, 2)):
        rids.append(eng.submit(prompt, max_new_tokens=9))
        eng._admit()
        rows.append(_slot_rows(eng, slot, len(prompt)))
        eng.step()
    eng.run()
    return [eng.result(r).tokens for r in rids], rows


@pytest.mark.parametrize("option", sorted(EXTEND_OPTIONS))
def test_engine_extend_graph_equals_eager(option):
    """The chunked prefill's captured graph against the eager card path:
    tokens and the long prompts' cache rows bitwise equal, for the bf16
    and int8 KV caches, int8 weights and the paged pool (the second long
    prompt shares the first's pages, write_from past its first chunk)."""
    model_option, kw = EXTEND_OPTIONS[option]
    with torch.no_grad():
        want, want_rows = _extend_trace(
            _small_engine(model_option, eager=True, **kw))
        eng = _small_engine(model_option, **kw)
        got, got_rows = _extend_trace(eng)
    assert got == want
    for got_slot, want_slot in zip(got_rows, want_rows):
        for g, w in zip(got_slot, want_slot):
            assert g.keys() == w.keys()
            assert all(torch.equal(g[n], w[n]) for n in g)
    assert [k for k in eng._graphs if k[0] == "extend"] == [
        ("extend", 32, "greedy")]
    if option == "paged":
        assert eng.blocks.shared_refs_total >= 2


def test_engine_extend_one_graph_serves_every_slot_and_start():
    """Warmup captures the extend; long prompts on other slots and starts,
    greedy, then a restricted sampled one, replay one graph a variant, and
    the greedy tokens equal eager's: no host value is baked into the
    capture."""
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    prompts = [([5, 6, 7], 24), (EXTEND_HOLDER, 9), (EXTEND_SHARER, 9),
               (list(range(60, 130)), 5)]
    with torch.no_grad():
        want = _serve(_small_engine("staged", eager=True), prompts)
        eng = _small_engine("staged")
        eng.warmup(48)
        extends = [k for k in eng._graphs if k[0] == "extend"]
        assert extends == [("extend", 32, "greedy")]
        k1 = flash_attention.fwd_launches
        eng.prefill_dispatches = eng.extend_dispatches = 0
        got = _serve(eng, prompts)
        assert [k for k in eng._graphs if k[0] == "extend"] == extends
        assert eng.extend_dispatches == 2 + 2 + 3
        assert flash_attention.fwd_launches - k1 == (
            eng.model.cfg.num_layers
            * (eng.prefill_dispatches + eng.extend_dispatches))
        sampled = _serve(eng, [(EXTEND_SHARER, 6)], temperature=0.8,
                         top_k=20, top_p=0.9)
    assert got == want
    assert len(sampled[0]) == 6
    assert sorted(k for k in eng._graphs if k[0] == "extend") == [
        ("extend", 32, "greedy"), ("extend", 32, "restricted")]


# ------------------------------------------------- int8 weights (K4)

def _int8_operands(m, n, k, period, seed=0):
    """bf16 x [m, k] and a weight quantized as the engine quantizes it:
    int8 [n, k] and bf16 scales [n, period]."""
    from kubeflow_tpu_torch.serving.engine import _quantize_leaf

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n, k, generator=g, device="cuda") * 0.02
    q, scale = _quantize_leaf(w, period)
    x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    return x, q, scale


def _int8_plain(x, q, scale):
    from kubeflow_tpu_torch.ops.int8_linear import dequantize_int8

    return torch.nn.functional.linear(x, dequantize_int8(q, scale))


def _check_int8(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


# Ragged token counts around the decode kernel's 8- and 16-token blocks and
# the prefill kernel's 64-, 128- and 256-token tiles; N with a ragged last
# 128-row tile; K with a ragged last 64-wide span. N = 1040 at M = 4096
# takes 256-token tiles, the others 64 or 128.
@pytest.mark.parametrize("n,k,period", [
    (1040, 1024, 1), (1040, 1024, 128), (512, 1280, 128), (256, 1040, 1),
    (256, 1040, 16)])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 17, 63, 64, 65, 127, 128, 129,
                               257, 513, 4096])
def test_int8_linear_matches_plain(m, n, k, period):
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    x, q, scale = _int8_operands(m, n, k, period)
    before = int8_linear.launches
    with torch.no_grad():
        got = int8_linear(x, q, scale)
    assert int8_linear.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _check_int8(got, _int8_plain(x, q, scale))


# 256-token tiles at ragged N, K and M: tiles leaving more than half the
# SMs busy take 256 tokens (33 row tiles x 4 token tiles here). K = 1040
# ends in a ragged 64-wide stage; S = 128 must divide K.
@pytest.mark.parametrize("period,k", [(1, 1040), (16, 1040), (128, 1152)])
def test_int8_linear_long_prefill_tiles_ragged(period, k):
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    x, q, scale = _int8_operands(1000, 4112, k, period, seed=5)
    with torch.no_grad():
        got = int8_linear(x, q, scale)
        assert torch.equal(got, int8_linear(x, q, scale))
    _check_int8(got, _int8_plain(x, q, scale))


def _int8_group_operands(m, period, ns=(1040, 256, 256), seed=6):
    x, q, scale = _int8_operands(m, ns[0], 1024, period, seed=seed)
    pairs = [(q, scale)]
    for i, n in enumerate(ns[1:]):
        _, q, scale = _int8_operands(1, n, 1024, period, seed=seed + 1 + i)
        pairs.append((q, scale))
    return x, pairs


# The grouped launch: ragged products (N 1040 / 256 / 256) at decode and
# prefill token counts, per-row and per-column scales.
@pytest.mark.parametrize("period", [1, 128])
@pytest.mark.parametrize("m", [1, 8, 9, 16, 64, 129, 513, 4096])
def test_int8_linear_group_matches_plain(m, period):
    from kubeflow_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_group,
    )

    x, pairs = _int8_group_operands(m, period)
    before = int8_linear.launches
    with torch.no_grad():
        got = int8_linear_group(x, pairs)
        assert int8_linear.launches == before + 1           # one launch
        again = int8_linear_group(x, pairs)
        apart = [int8_linear(x, q, scale) for q, scale in pairs]
    for y, y2, y1, (q, scale) in zip(got, again, apart, pairs):
        assert y.shape == (m, q.shape[0]) and y.dtype == torch.bfloat16
        assert torch.equal(y, y2)
        _check_int8(y, _int8_plain(x, q, scale))
        _check_int8(y, y1)


def test_int8_linear_group_graph_replay_equals_eager():
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear_group

    for m in (8, 513):
        x, pairs = _int8_group_operands(m, 1, seed=9)
        with torch.no_grad():
            want = int8_linear_group(x, pairs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                int8_linear_group(x, pairs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = int8_linear_group(x, pairs)
            x.copy_(torch.randn_like(x.float()).bfloat16())
            graph.replay()
            again = int8_linear_group(x, pairs)
            assert all(torch.equal(a, b) for a, b in zip(out, again))
            assert not torch.equal(out[0], want[0])


def test_int8_linear_group_refusals():
    from kubeflow_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_group,
    )

    x, pairs = _int8_group_operands(8, 1)
    _, mixed = _int8_group_operands(8, 128)
    before = int8_linear.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="all 1 or all"):
            int8_linear_group(x, [pairs[0], mixed[1]])
        with pytest.raises(ValueError, match="1 to 3"):
            int8_linear_group(x, pairs + pairs[:1])
        with pytest.raises(ValueError, match="bf16 x"):
            int8_linear_group(x.float(), pairs)
    assert int8_linear.launches == before


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("period", [1, 128])
def test_int8_linear_cluster_splits_agree(period, m, splits):
    """The decode kernel with K split over 1-8 blocks of a cluster (their
    partials summed through distributed shared memory)."""
    from kubeflow_tpu_torch.ops import int8_linear as il

    x, q, scale = _int8_operands(m, 1040, 4096, period, seed=1)
    with torch.no_grad():
        got = il._kernel(x, q, scale, None, splits=splits)
        assert torch.equal(got, il._kernel(x, q, scale, None, splits=splits))
    _check_int8(got, _int8_plain(x, q, scale))


@pytest.mark.parametrize("period", [1, 128])
@pytest.mark.parametrize("m", [8, 513])
def test_int8_linear_is_deterministic(m, period):
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    x, q, scale = _int8_operands(m, 4096, 14336 if m == 8 else 4096, period,
                                 seed=2)
    with torch.no_grad():
        assert torch.equal(int8_linear(x, q, scale), int8_linear(x, q, scale))


def test_int8_linear_graph_replay_equals_eager():
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    x, q, scale = _int8_operands(8, 1024, 4096, 128, seed=3)
    with torch.no_grad():
        want = int8_linear(x, q, scale)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            int8_linear(x, q, scale)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = int8_linear(x, q, scale)
        x.copy_(torch.randn_like(x.float()).bfloat16())
        graph.replay()
        assert torch.equal(out, int8_linear(x, q, scale))
        assert not torch.equal(out, want)


def test_int8_linear_refusals():
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    x, q, scale = _int8_operands(8, 256, 1024, 1, seed=4)
    before = int8_linear.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="bf16 x"):
            int8_linear(x.float(), q, scale)
        with pytest.raises(ValueError, match="multiples of 16"):
            int8_linear(x[:, :1000], q[:, :1000].contiguous(), scale)
        with pytest.raises(ValueError, match="scale period"):
            int8_linear(x, q, scale.expand(256, 24).contiguous())
        with pytest.raises(ValueError, match="bf16 scale"):
            int8_linear(x, q, scale[:128])
    assert int8_linear.launches == before


def test_engine_int8_weight_graph_tokens_equal_eager():
    """Graphed int8-weight serving (staged int8 KV cache too) against the
    eager card path; K4 launches once per group of projections (q/k/v,
    gate/up), other projection and the lm_head per step and per grouped
    prefill or extend, replays counted."""
    from kubeflow_tpu_torch.models.llama import (
        Int8Dense,
        int8_launches_per_pass,
    )
    from kubeflow_tpu_torch.ops.int8_linear import int8_linear

    kw = dict(quantize="int8", quantize_min_size=1024)
    for option in ("staged", "int8_staged"):
        with torch.no_grad():
            want = _serve(_small_engine(option, eager=True, **kw))
            eng = _small_engine(option, **kw)
            eng.warmup(16)
            k4 = int8_linear.launches
            eng.prefill_dispatches = eng.extend_dispatches = 0
            eng.decode_dispatches = 0
            got = _serve(eng)
        assert got == want
        layers = eng.model.cfg.num_layers
        assert len(eng.quantized) == 7 * layers + 1
        assert isinstance(eng.model.lm_head, Int8Dense)
        # One launch per group the model forms (q/k/v, gate/up), one per
        # other int8 projection (o, down) and the lm_head.
        per_pass = int8_launches_per_pass(eng.model)
        assert per_pass == 4 * layers + 1
        assert int8_linear.launches - k4 == per_pass * (
            eng.cfg.decode_chunk * eng.decode_dispatches
            + eng.prefill_dispatches + eng.extend_dispatches)


def test_card_int8_serve_never_dequantizes_whole_weights(monkeypatch):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops import int8_linear as il

    def refuse(*args, **kwargs):
        raise AssertionError("the card's serve path dequantized a weight")

    monkeypatch.setattr(il, "int8_linear_reference", refuse)
    monkeypatch.setattr(il, "dequantize_int8", refuse)
    monkeypatch.setattr(llama, "dequantize_int8", refuse)
    for eager in (True, False):
        with torch.no_grad():
            toks = _serve(_small_engine("staged", eager=eager,
                                        quantize="int8",
                                        quantize_min_size=1024))
        assert [len(t) for t in toks] == [n for _, n in ENGINE_PROMPTS]


# ------------------------------------------- the training step's fused work
# K6 (RMSNorm) and K7 (RoPE) within one ulp of the plain version in the
# output's dtype (an element below 2^-8 of the tensor's largest compared at
# that scale: dx and dweight are row and column sums taken in another
# order, and an element near a cancellation keeps its terms' absolute
# error); K7 rounds as its plain version does and is also bitwise equal.
# K8: the loss within relative 1e-5, dlogits within 2e-2 x max |plain|,
# hits equal. K5: bitwise equal to the plain update given the same norm
# tensor; the norm within relative 1e-6 of an f64 sum.


def _ulp_ok(got: torch.Tensor, want: torch.Tensor, floor: float = 2 ** -8):
    """|got - want| within one bf16 ulp (7 mantissa bits) of
    max(|want|, floor x max |want|), whatever the dtype."""
    bits = 7
    w = want.float()
    scale = w.abs().clamp_min(floor * float(w.abs().max()))
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - 1 - bits)
    err = float(((got.detach().float() - w).abs() / ulp).max())
    assert err <= 1.0, f"{err:.2f} ulp"


@pytest.mark.parametrize("shape,xdt,wdt", [
    ((4096, 2048), torch.bfloat16, torch.bfloat16),     # train rows
    ((8, 1, 4096), torch.bfloat16, torch.bfloat16),     # a decode step
    ((3, 700, 4096), torch.bfloat16, torch.bfloat16),   # a prefill
    ((33, 8192), torch.bfloat16, torch.float32),
    ((100, 2048), torch.float32, torch.bfloat16)])
def test_rms_norm_kernel_matches_plain(shape, xdt, wdt):
    from kubeflow_tpu_torch.ops.norms import (
        rms_norm,
        rms_norm_backward_reference,
        rms_norm_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(30)
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(xdt)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
         ).to(wdt)
    dy = torch.randn(shape, generator=g, device="cuda").to(xdt)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = rms_norm.fwd_launches, rms_norm.bwd_launches
    y = rms_norm(xr, wr, eps=1e-5)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (rms_norm.fwd_launches, rms_norm.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want, rstd = rms_norm_reference(x, w, eps=1e-5)
    want_dx, want_dw = rms_norm_backward_reference(x, w, dy, rstd)
    _ulp_ok(y, want)
    _ulp_ok(xr.grad, want_dx)
    _ulp_ok(wr.grad, want_dw)
    assert xr.grad.dtype == xdt and wr.grad.dtype == wdt


def test_rms_norm_kernel_is_deterministic_and_graph_safe():
    from kubeflow_tpu_torch.ops import norms

    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(3000, 2048, generator=g, device="cuda").bfloat16()
    w = torch.randn(2048, generator=g, device="cuda").bfloat16()
    dy = torch.randn(3000, 2048, generator=g, device="cuda").bfloat16()
    y1, r1 = norms._fwd_kernel(x, w, 1e-6)
    y2, r2 = norms._fwd_kernel(x, w, 1e-6)
    d1 = norms._bwd_kernel(x, w, dy, r1)
    d2 = norms._bwd_kernel(x, w, dy, r1)
    assert torch.equal(y1, y2) and torch.equal(r1, r2)
    assert all(torch.equal(a, b) for a, b in zip(d1, d2))
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            norms.rms_norm(x, w)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = norms.rms_norm(x, w)
        x.copy_(torch.randn_like(x.float()).bfloat16())
        graph.replay()
        assert torch.equal(out, norms.rms_norm(x, w))


def test_rms_norm_refusals_and_cpu():
    from kubeflow_tpu_torch.ops.norms import rms_norm

    x = torch.randn(4, 2048, device="cuda").bfloat16()
    w = torch.ones(2048, device="cuda").bfloat16()
    before = rms_norm.fwd_launches
    with pytest.raises(ValueError, match="multiple of 8"):
        rms_norm(x[:, :2044].contiguous(), w[:2044])
    with pytest.raises(ValueError, match="multiple of 8"):
        rms_norm(torch.zeros(2, 16384, device="cuda").bfloat16(),
                 torch.ones(16384, device="cuda").bfloat16())
    with pytest.raises(ValueError, match="bf16 or f32"):
        rms_norm(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        rms_norm(torch.ones(4, 2048, device="cuda").bfloat16()[:, :1024],
                 w[:1024])
    rms_norm(x.cpu(), w.cpu())              # the plain version
    assert rms_norm.fwd_launches == before


def _rope_case(b, s, hq, hk, dtype, seed, L=2048):
    from kubeflow_tpu_torch.ops.rope import rope_frequencies

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, hq, 128, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s, hk, 128, generator=g, device="cuda").to(dtype)
    pos = torch.randint(0, L + 40, (b, s), generator=g, device="cuda")
    cos, sin = rope_frequencies(128, L, theta=500000.0, device="cuda")
    return q, k, pos, cos, sin


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,hq,hk,pdt", [
    (2, 300, 16, 8, torch.int64), (8, 1, 32, 8, torch.int64),
    (1, 512, 32, 8, torch.int32)])
def test_rope_kernel_matches_plain_bitwise(b, s, hq, hk, pdt, dtype):
    from kubeflow_tpu_torch.ops.rope import apply_rope, apply_rope_qk, \
        rope_reference

    q, k, pos, cos, sin = _rope_case(b, s, hq, hk, dtype, 32)
    pos = pos.to(pdt)          # some past the table: clamped
    qr, kr = q.clone().requires_grad_(), k.clone().requires_grad_()
    before = apply_rope.fwd_launches, apply_rope.bwd_launches
    qo, ko = apply_rope_qk(qr, kr, cos, sin, positions=pos)
    dq, dk = torch.randn_like(qo), torch.randn_like(ko)
    torch.autograd.backward([qo, ko], [dq, dk])
    torch.cuda.synchronize()
    assert (apply_rope.fwd_launches, apply_rope.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for got, x, inv in ((qo, q, False), (ko, k, False), (qr.grad, dq, True),
                        (kr.grad, dk, True)):
        want = rope_reference(x, cos, sin, positions=pos, inverse=inv)
        _ulp_ok(got, want)
        assert torch.equal(got, want)


def test_rope_kernel_strided_views_deterministic_and_graph_safe():
    from kubeflow_tpu_torch.ops.rope import apply_rope_qk, rope_reference

    _, _, pos, cos, sin = _rope_case(2, 64, 1, 1, torch.bfloat16, 33)
    g = torch.Generator(device="cuda").manual_seed(34)
    qkv = torch.randn(2, 64, 48, 128, generator=g, device="cuda").bfloat16()
    q, k = qkv[:, :, :32], qkv[:, :, 32:40]         # views of one buffer
    a = apply_rope_qk(q, k, cos, sin, positions=pos)
    b = apply_rope_qk(q, k, cos, sin, positions=pos)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[1], rope_reference(k, cos, sin, positions=pos))
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            apply_rope_qk(q, k, cos, sin, positions=pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = apply_rope_qk(q, k, cos, sin, positions=pos)
        pos.copy_(torch.randint_like(pos, 0, 2048))
        graph.replay()
        want = apply_rope_qk(q, k, cos, sin, positions=pos)
        assert all(torch.equal(x, y) for x, y in zip(out, want))


def test_rope_refusals_and_cpu():
    from kubeflow_tpu_torch.ops.rope import apply_rope, apply_rope_qk

    q, k, pos, cos, sin = _rope_case(1, 8, 4, 2, torch.bfloat16, 35)
    before = apply_rope.fwd_launches
    with pytest.raises(ValueError, match="multiple of 16"):
        apply_rope_qk(q[..., :120], k[..., :120], cos[:, :60].contiguous(),
                      sin[:, :60].contiguous(), positions=pos)
    with pytest.raises(ValueError, match="positions"):
        apply_rope_qk(q, k, cos, sin, positions=pos.float())
    with pytest.raises(ValueError, match="bf16 or f32"):
        apply_rope_qk(q.half(), k.half(), cos, sin, positions=pos)
    with pytest.raises(ValueError, match="does not match"):
        apply_rope_qk(q, k.float(), cos, sin, positions=pos)
    apply_rope_qk(q.cpu(), k.cpu(), cos.cpu(), sin.cpu(),
                  positions=pos.cpu())          # the plain version
    assert apply_rope.fwd_launches == before


@pytest.mark.parametrize("dtype,V,kw,masked", [
    (torch.bfloat16, 32000, {"z_loss_weight": 1e-4}, False),
    (torch.bfloat16, 32000, {"z_loss_weight": 1e-4}, True),
    (torch.bfloat16, 128256, {"label_smoothing": 0.1}, True),
    (torch.float32, 32000, {"z_loss_weight": 1e-3,
                            "label_smoothing": 0.2}, False)])
def test_cross_entropy_kernel_matches_plain(dtype, V, kw, masked):
    from kubeflow_tpu_torch.ops.cross_entropy import (
        cross_entropy_backward_reference,
        cross_entropy_reference,
        cross_entropy_sums,
    )

    g = torch.Generator(device="cuda").manual_seed(36)
    n = 1024
    logits = (torch.randn(n, V, generator=g, device="cuda") * 4).to(dtype)
    labels = torch.randint(0, V, (n,), generator=g, device="cuda")
    labels[::5] = logits[::5].float().argmax(-1)     # some hits
    mask = (torch.rand(n, generator=g, device="cuda") > 0.2).float() \
        if masked else None
    x = logits.clone().requires_grad_()
    before = cross_entropy_sums.fwd_launches, cross_entropy_sums.bwd_launches
    s_nll, s_w, s_hit = cross_entropy_sums(x, labels, mask, **kw)
    (s_nll / s_w).backward()
    torch.cuda.synchronize()
    assert (cross_entropy_sums.fwd_launches,
            cross_entropy_sums.bwd_launches) == (before[0] + 1,
                                                 before[1] + 1)
    zw, ls = kw.get("z_loss_weight", 0.0), kw.get("label_smoothing", 0.0)
    want, logz = cross_entropy_reference(logits, labels, mask, zw, ls)
    assert float(s_nll) == pytest.approx(float(want[0]), rel=1e-5)
    assert float(s_w) == float(want[1]) and float(s_hit) == float(want[2])
    want_d = cross_entropy_backward_reference(
        logits, labels, mask, logz, 1.0 / want[1], zw, ls)
    assert x.grad.dtype == dtype
    err = float((x.grad.float() - want_d.float()).abs().max())
    assert err <= 2e-2 * float(want_d.float().abs().max())


def test_cross_entropy_kernel_is_deterministic_and_refuses():
    from kubeflow_tpu_torch.ops import cross_entropy as ce

    g = torch.Generator(device="cuda").manual_seed(37)
    logits = torch.randn(2000, 32000, generator=g, device="cuda").bfloat16()
    labels = torch.randint(0, 32000, (2000,), generator=g, device="cuda")
    a, la = ce._fwd_kernel(logits, labels, None, 1e-4, 0.0)
    b, lb = ce._fwd_kernel(logits, labels, None, 1e-4, 0.0)
    assert torch.equal(a, b) and torch.equal(la, lb)
    one = torch.ones((), device="cuda")
    assert torch.equal(ce._bwd_kernel(logits, labels, None, la, one, 1e-4, 0),
                       ce._bwd_kernel(logits, labels, None, la, one, 1e-4, 0))
    before = ce.cross_entropy_sums.fwd_launches
    with pytest.raises(ValueError, match="multiple of 8"):
        ce.cross_entropy_sums(logits[:, :31999].contiguous(), labels)
    with pytest.raises(ValueError, match="contiguous"):
        ce.cross_entropy_sums(logits[:, :16000], labels)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ce.cross_entropy_sums(logits.half(), labels)
    ce.cross_entropy_sums(logits[:8].cpu(), labels[:8].cpu())   # plain
    assert ce.cross_entropy_sums.fwd_launches == before


def _opt_state(kind, pdt, gdt, mdt, seed=38):
    g = torch.Generator(device="cuda").manual_seed(seed)
    sizes = [65536 * 3 + 5, 2048 * 7, 33, 1, 65536, 1000003]
    mk = lambda n, s, dt: (torch.randn(n, generator=g, device="cuda")  # noqa: E731
                           * s).to(dt)
    p = [mk(n, 1.0, pdt) for n in sizes]
    gr = [mk(n, 0.05, gdt) for n in sizes]
    m = [mk(n, 0.01, mdt if kind != "sgd" else torch.float32)
         for n in sizes]
    v = [mk(n, 1e-3, torch.float32).abs() for n in sizes] \
        if kind == "adamw" else None
    return p, gr, m, v


@pytest.mark.parametrize("kind,pdt,gdt,mdt", [
    ("adamw", torch.bfloat16, torch.bfloat16, torch.bfloat16),
    ("adamw", torch.bfloat16, torch.float32, torch.float32),
    ("adamw", torch.float32, torch.float32, torch.bfloat16),
    ("lion", torch.bfloat16, torch.bfloat16, torch.bfloat16),
    ("sgd", torch.float32, torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("max_norm", [1.0, 1e4])          # clipped or not
def test_optimizer_kernel_bitwise_plain(kind, pdt, gdt, mdt, max_norm):
    from kubeflow_tpu_torch.ops import optimizer as fused

    p, gr, m, v = _opt_state(kind, pdt, gdt, mdt)
    norm = fused.global_norm(gr)
    exact = sum(float((t.double() ** 2).sum()) for t in gr) ** 0.5
    assert float(norm) == pytest.approx(exact, rel=1e-6)
    assert torch.equal(norm, fused.global_norm(gr))
    hyper = fused.Hyper(max_norm=max_norm, b1=0.9, b2=0.95, bc1=0.19,
                        bc2=0.0975, weight_decay=0.1, lr=3e-4)
    cp = lambda ts: None if ts is None else [t.clone() for t in ts]  # noqa: E731
    p2, m2, v2 = cp(p), cp(m), cp(v)
    before = fused.update.launches
    fused.update(kind, p, gr, m, v, norm, hyper)
    fused.update_reference(kind, p2, gr, m2, v2, norm, hyper)
    torch.cuda.synchronize()
    assert fused.update.launches == before + 1
    for a, b in zip(p + m + (v or []), p2 + m2 + (v2 or [])):
        assert torch.equal(a, b)


def test_optimizer_kernel_refusals_and_cpu():
    from kubeflow_tpu_torch.ops import optimizer as fused

    p, gr, m, v = _opt_state("adamw", torch.bfloat16, torch.bfloat16,
                             torch.bfloat16)
    norm = fused.global_norm(gr)
    hyper = fused.Hyper(max_norm=1.0, b1=0.9, b2=0.95)
    before = fused.update.launches, fused.global_norm.launches
    with pytest.raises(ValueError, match="contiguous"):
        fused.update("adamw", [p[1].view(7, 2048).t()], [gr[1]], [m[1]],
                     [v[1]], norm, hyper)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fused.update("adamw", [p[2].half()], [gr[2]], [m[2]], [v[2]],
                     norm, hyper)
    with pytest.raises(ValueError, match="nu f32"):
        fused.update("adamw", [p[2]], [gr[2]], [m[2]], [v[2].bfloat16()],
                     norm, hyper)
    with pytest.raises(ValueError, match="one"):
        fused.update("adamw", [p[2].cpu()], [gr[2]], [m[2]], [v[2]],
                     norm, hyper)
    cpu = lambda ts: [t.cpu() for t in ts]   # noqa: E731
    n_cpu = fused.global_norm(cpu(gr))       # the plain versions
    fused.update("adamw", cpu(p), cpu(gr), cpu(m), cpu(v), n_cpu, hyper)
    assert (fused.update.launches, fused.global_norm.launches) == before


# K11 (adafactor): the kernel against its plain version on the same
# inputs, moments within 1e-6 relative of it in f64, params within one
# bf16 ulp of max(|plain|, 2^-8 max |plain|) of it in f32 (the sums are
# taken in another order); two calls bitwise equal.
K11_SMALL = dict(vocab_size=320, embed_dim=256, num_layers=2, num_heads=2,
                 num_kv_heads=1, head_dim=128, mlp_dim=384)
K11_700M = dict(vocab_size=32000, embed_dim=2048, num_layers=12,
                num_heads=16, num_kv_heads=8, head_dim=128, mlp_dim=5632)


def _adafactor_case(model_kw, pdt, gdt, seed=41):
    from kubeflow_tpu_torch.models.layout import jax_leaves
    from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
    from kubeflow_tpu_torch.ops import adafactor

    cfg = LlamaConfig(**model_kw)
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in Llama(cfg).named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s, sc, dt: (torch.randn(s, generator=g, device="cuda")  # noqa: E731
                            * sc).to(dt)
    params = {n: mk(s, 0.02, pdt) for n, s in shapes.items()}
    grads = {n: mk(s, 1e-3, gdt) for n, s in shapes.items()}
    leaves = jax_leaves(cfg)
    state = adafactor.init_state(params, leaves)
    for key in ("v_row", "v_col", "v"):        # moments of earlier steps
        for m in state[key].values():
            m.copy_(torch.rand(m.shape, generator=g, device="cuda") * 1e-6
                    + 1e-8)
    return params, grads, state, leaves


def _copy_state(state):
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in state.items()}


def _k11_check(model_kw, pdt, gdt, max_norm):
    """K11 against its plain version; max_norm None: half the gradients'
    norm (clipped). Returns the state and the norm K11 computed."""
    from kubeflow_tpu_torch.ops import adafactor
    from kubeflow_tpu_torch.ops import optimizer as fused

    params, grads, state, leaves = _adafactor_case(model_kw, pdt, gdt)
    want = fused.global_norm(list(grads.values()))
    if max_norm is None:
        max_norm = 0.5 * float(want)
    hyper = adafactor.Hyper(max_norm=max_norm, count=3, lr=1e-2,
                            weight_decay=0.1)
    p2, p3, p4 = ({n: t.clone() for n, t in params.items()}
                  for _ in range(3))
    s2, s3, s4 = (_copy_state(state) for _ in range(3))
    before = adafactor.update.launches, fused.global_norm.launches
    norm = adafactor.update(params, grads, state, leaves, hyper)
    norm3 = adafactor.update(p3, grads, s3, leaves, hyper)
    adafactor.update_reference(p2, grads, s2, leaves, hyper)
    adafactor.update_reference(p4, grads, s4, leaves, hyper,
                               dtype=torch.float64)
    torch.cuda.synchronize()
    # Two K11 calls; no K5 norm: K11 sums the gradients' squares itself.
    assert (adafactor.update.launches, fused.global_norm.launches) == (
        before[0] + 2, before[1])
    assert norm.shape == () and torch.equal(norm, norm3)
    assert abs(float(norm) - float(want)) <= 1e-6 * float(want)
    for n in params:
        assert torch.equal(params[n], p3[n]), n
        _ulp_ok(params[n], p2[n])
    for key in ("v_row", "v_col", "v"):
        for n, m in state[key].items():
            assert torch.equal(m, s3[key][n]), (key, n)
            torch.testing.assert_close(m, s4[key][n], rtol=1e-6, atol=0)
    return state, norm


@pytest.mark.parametrize("scanned", [True, False])
@pytest.mark.parametrize("pdt,gdt", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("max_norm", [1.0, 1e4])          # clipped or not
def test_adafactor_kernel_matches_plain_small(scanned, pdt, gdt, max_norm):
    state, _ = _k11_check(dict(K11_SMALL, scan_layers=scanned), pdt, gdt,
                          max_norm)
    assert state["v_row"] and state["v"]


@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("clip", [True, False])
def test_adafactor_kernel_folds_the_norm(pdt, clip):
    """The scanned 2-layer model (o_proj's fast axis is its 128-wide
    head_dim: narrow tiles; the norms unfactored): the norm K11 computes
    within 1e-6 of K5's, with no K5 launch; clipped or not against the
    plain version, two calls bitwise."""
    from kubeflow_tpu_torch.ops import adafactor

    before = adafactor.update.table_builds
    state, norm = _k11_check(dict(K11_SMALL, scan_layers=True), pdt, pdt,
                             None if clip else 1e4)
    assert state["v"] and float(norm) > 0
    assert adafactor.update.table_builds == before + 2   # two param sets
    plan = next(reversed(adafactor._plans.values()))
    flags = dict(zip(plan.order, plan.table[:, adafactor.FIELDS.index(
        "flags")].tolist()))
    narrow = {n for n, f in flags.items() if f & adafactor._NARROW}
    assert narrow == {n for n in flags if "o_proj" in n}


@pytest.mark.parametrize("kw", [
    dict(fused_qkv=True, fused_gate_up=True, scan_layers=True),
    dict(vocab_size=256, embed_dim=64, num_layers=2, num_heads=4,
         num_kv_heads=2, head_dim=16, mlp_dim=128, scan_layers=False)])
def test_adafactor_kernel_fused_and_unfactored(kw):
    # Two batch axes (the fused q/k/v [E, Hkv, G + 2, Dh]); a tiny model
    # whose tensors are all unfactored (v laid out as each [out, in]
    # weight, seen in its JAX shape).
    _k11_check(dict(K11_SMALL, **kw), torch.bfloat16, torch.bfloat16, 1.0)


@pytest.mark.parametrize("scanned", [True, False])
def test_adafactor_kernel_matches_plain_700m(scanned):
    _k11_check(dict(K11_700M, scan_layers=scanned), torch.bfloat16,
               torch.bfloat16, 1.0)


def test_adafactor_kernel_refusals_and_cpu():
    from kubeflow_tpu_torch.ops import adafactor

    params, grads, state, leaves = _adafactor_case(
        dict(K11_SMALL, scan_layers=True), torch.bfloat16, torch.bfloat16)
    hyper = adafactor.Hyper(max_norm=1.0, count=0, lr=1e-2)
    before = adafactor.update.launches
    name = "layers.0.mlp.down_proj.weight"
    bad = dict(params, **{name: params[name].t().contiguous().t()})
    with pytest.raises(ValueError, match="contiguous"):
        adafactor.update(bad, grads, state, leaves, hyper)
    bad = dict(params, **{name: params[name].half()})
    with pytest.raises(ValueError, match="bf16 or f32"):
        adafactor.update(bad, grads, state, leaves, hyper)
    bad = dict(grads, **{name: grads[name].t()})
    with pytest.raises(ValueError, match="contiguous"):
        adafactor.update(params, bad, state, leaves, hyper)
    wrong = _copy_state(state)
    wrong["v_row"][name] = wrong["v_row"][name].bfloat16()
    with pytest.raises(ValueError, match="f32 moments"):
        adafactor.update(params, grads, wrong, leaves, hyper)
    cpu = lambda d: {n: t.cpu() for n, t in d.items()}   # noqa: E731
    norm = adafactor.update(cpu(params), cpu(grads),
                            {k: cpu(v) if isinstance(v, dict) else v
                             for k, v in state.items()}, leaves, hyper)
    assert adafactor.update.launches == before and norm.device.type == "cpu"


def test_device_feed_copies_through_pinned_buffers():
    import numpy as np

    from kubeflow_tpu_torch.train.runner import DeviceFeed

    feed = DeviceFeed(torch.device("cuda"))
    rng = np.random.default_rng(5)
    batches = [{"inputs": rng.integers(0, 32000, (12, 2049),
                                       dtype=np.int32)} for _ in range(5)]
    outs = [feed(b) for b in batches]       # two buffers, reused in turn
    torch.cuda.synchronize()
    for b, o in zip(batches, outs):
        assert o["inputs"].device.type == "cuda"
        assert torch.equal(o["inputs"].cpu(), torch.from_numpy(b["inputs"]))


def test_rope_backward_takes_a_transposed_grad():
    # The plain attention's dk comes out of its product with the head dim
    # strided; the backward copies it into the layout the kernel reads.
    from kubeflow_tpu_torch.ops.rope import apply_rope_qk, rope_reference

    q, k, pos, cos, sin = _rope_case(2, 64, 4, 2, torch.bfloat16, 39)
    qr, kr = q.clone().requires_grad_(), k.clone().requires_grad_()
    qo, ko = apply_rope_qk(qr, kr, cos, sin, positions=pos)
    dk = torch.randn(2, 2, 128, 64, device="cuda").bfloat16().permute(
        0, 3, 1, 2)
    assert dk.shape == ko.shape and dk.stride(3) != 1
    torch.autograd.backward([qo, ko], [torch.zeros_like(qo), dk])
    assert torch.equal(kr.grad, rope_reference(
        dk.contiguous(), cos, sin, positions=pos, inverse=True))


# K9 (SwiGLU): bitwise its plain version, both layouts, forward and
# backward. K10 (the residual add + RMSNorm): the sum bitwise the eager
# add, y and dx within one bf16 ulp (the norm's statistics summed in
# another order, as K6). K7's strided mode (the fused q/k/v projection
# read in place, its gradient written into the fused slots): bitwise.


def _swiglu_case(rows, F, seed, fused):
    g = torch.Generator(device="cuda").manual_seed(seed)
    gu = (torch.randn(rows, 2, F, generator=g, device="cuda") * 3).bfloat16()
    dh = torch.randn(rows, F, generator=g, device="cuda").bfloat16()
    if fused:
        return (gu,), dh
    return (gu[:, 0].contiguous(), gu[:, 1].contiguous()), dh


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rows,F", [(4096, 5632), (8, 14336), (512, 14336),
                                    (3, 16)])
def test_swiglu_kernel_matches_plain_bitwise(rows, F, fused):
    from kubeflow_tpu_torch.ops.swiglu import (
        swiglu,
        swiglu_backward_reference,
        swiglu_fused,
        swiglu_reference,
    )

    args, dh = _swiglu_case(rows, F, 40, fused)
    leaves = [a.clone().requires_grad_() for a in args]
    before = swiglu.fwd_launches, swiglu.bwd_launches
    h = (swiglu_fused if fused else swiglu)(*leaves)
    h.backward(dh)
    assert (swiglu.fwd_launches, swiglu.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    gate, up = (args[0][:, 0], args[0][:, 1]) if fused else args
    assert torch.equal(h, swiglu_reference(gate, up))
    dg, du = swiglu_backward_reference(gate, up, dh)
    got = (leaves[0].grad[:, 0], leaves[0].grad[:, 1]) if fused else (
        leaves[0].grad, leaves[1].grad)
    assert torch.equal(got[0], dg) and torch.equal(got[1], du)


def test_swiglu_kernel_f32_graph_safe_and_refusals():
    from kubeflow_tpu_torch.ops.swiglu import swiglu, swiglu_reference

    g = torch.Generator(device="cuda").manual_seed(41)
    gate, up = (torch.randn(2, 64, 256, generator=g, device="cuda")
                for _ in range(2))
    assert torch.equal(swiglu(gate, up), swiglu_reference(gate, up))
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            swiglu(gate, up)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = swiglu(gate, up)
        gate.mul_(-1)
        graph.replay()
        assert torch.equal(out, swiglu_reference(gate, up))
    before = swiglu.fwd_launches
    with pytest.raises(ValueError, match="multiple of"):
        swiglu(gate[..., :250], up[..., :250])
    with pytest.raises(ValueError, match="bf16 or f32"):
        swiglu(gate.half(), up.half())
    with pytest.raises(ValueError, match="rows"):
        swiglu(gate.transpose(0, 1), up.transpose(0, 1))
    swiglu(gate.cpu(), up.cpu())                 # the plain version
    assert swiglu.fwd_launches == before


@pytest.mark.parametrize("shape,wdt", [
    ((4096, 2048), torch.bfloat16), ((8, 1, 4096), torch.bfloat16),
    ((4096, 4096), torch.bfloat16), ((33, 8192), torch.float32)])
@pytest.mark.parametrize("with_dr", [True, False])
def test_add_rms_norm_kernel_matches_plain(shape, wdt, with_dr):
    """The norm's part of dx (no residual gradient) within one ulp, as
    K6's; with the residual's gradient dr, dx is bitwise dr + that part
    (one ulp of the part is many of a sum that cancels)."""
    from kubeflow_tpu_torch.ops import norms

    g = torch.Generator(device="cuda").manual_seed(42)
    x, h, dr, dy = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                    for _ in range(4))
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")).to(wdt)
    leaves = [t.clone().requires_grad_() for t in (x, h, w)]
    before = norms.add_rms_norm.fwd_launches, norms.add_rms_norm.bwd_launches
    r, y = norms.add_rms_norm(*leaves, eps=1e-5)
    torch.autograd.backward((r, y) if with_dr else (y,),
                            (dr, dy) if with_dr else (dy,))
    assert (norms.add_rms_norm.fwd_launches,
            norms.add_rms_norm.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_r, want_y, _ = norms.add_rms_norm_reference(x, h, w, eps=1e-5)
    assert torch.equal(r, want_r)
    _ulp_ok(y, want_y)
    _, _, rstd = norms._add_fwd_kernel(x, h, w, 1e-5)
    dxn, dw = norms._add_bwd_kernel(r, w, dy, rstd, None)
    want_dxn, want_dw = norms.add_rms_norm_backward_reference(
        r, w, dy, rstd, None)
    _ulp_ok(dxn, want_dxn)
    _ulp_ok(dw, want_dw)
    assert torch.equal(leaves[0].grad, dr + dxn if with_dr else dxn)
    assert torch.equal(leaves[0].grad, leaves[1].grad)
    assert torch.equal(leaves[2].grad, dw)


def _rows_cases():
    from kubeflow_tpu_torch.ops.norms import ROWS_MAX

    return sorted({1, 8, 48, ROWS_MAX - 1, ROWS_MAX, ROWS_MAX + 1})


@pytest.mark.parametrize("E", [2048, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_forward_matches_plain_and_takes_its_rows(dtype, E):
    """K10's and K6's forward at the serving decode's rows: the rows kernel
    up to ROWS_MAX rows, the present one above (their launch counters
    say which); through either kernel at every row count, the sum bitwise,
    y within one bf16 ulp of the plain version, two calls bitwise
    equal."""
    from kubeflow_tpu_torch.ops import norms

    g = torch.Generator(device="cuda").manual_seed(47)
    for rows in _rows_cases():
        x, h = (torch.randn(rows, E, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        w = (1 + 0.1 * torch.randn(E, generator=g, device="cuda")).to(dtype)
        small = rows <= norms.ROWS_MAX
        before = (norms.add_rms_norm.fwd_launches,
                  norms.add_rms_norm.rows_launches,
                  norms.rms_norm.fwd_launches, norms.rms_norm.rows_launches)
        with torch.no_grad():
            r, y = norms.add_rms_norm(x, h, w, eps=1e-6)
            y6 = norms.rms_norm(x, w, eps=1e-6)
        assert (norms.add_rms_norm.fwd_launches,
                norms.add_rms_norm.rows_launches,
                norms.rms_norm.fwd_launches,
                norms.rms_norm.rows_launches) == (
            before[0] + 1, before[1] + small, before[2] + 1,
            before[3] + small), rows
        want_r, want_y, _ = norms.add_rms_norm_reference(x, h, w, eps=1e-6)
        assert torch.equal(r, want_r), rows
        _ulp_ok(y, want_y)
        _ulp_ok(y6, norms.rms_norm_reference(x, w, eps=1e-6)[0])
        for by_rows in (True, False):        # either kernel at any rows
            a = norms._add_fwd_kernel(x, h, w, 1e-6, by_rows=by_rows)
            b = norms._add_fwd_kernel(x, h, w, 1e-6, by_rows=by_rows)
            assert all(torch.equal(u, v) for u, v in zip(a, b)), rows
            assert torch.equal(a[0], want_r)
            _ulp_ok(a[1], want_y)
            c = norms._fwd_kernel(x, w, 1e-6, by_rows=by_rows)
            assert all(torch.equal(u, v) for u, v in zip(
                c, norms._fwd_kernel(x, w, 1e-6, by_rows=by_rows)))
            _ulp_ok(c[0], norms.rms_norm_reference(x, w, eps=1e-6)[0])


@pytest.mark.parametrize("b,s,hkv,g", [(2, 300, 8, 2), (8, 1, 8, 4),
                                       (1, 512, 8, 4)])
def test_rope_fused_projection_matches_plain_bitwise(b, s, hkv, g):
    from kubeflow_tpu_torch.ops.rope import (
        apply_rope,
        apply_rope_fused,
        rope_reference,
    )

    q, _, pos, cos, sin = _rope_case(b, s, hkv * (g + 2), 1, torch.bfloat16,
                                     43)
    qkv = q.view(b, s, hkv, g + 2, 128).clone().requires_grad_()
    before = apply_rope.fwd_launches, apply_rope.bwd_launches
    qo, ko, vo = apply_rope_fused(qkv, cos, sin, positions=pos)
    gen = torch.Generator(device="cuda").manual_seed(44)
    cot = [torch.randn(t.shape, generator=gen, device="cuda").bfloat16()
           for t in (qo, ko, vo)]
    torch.autograd.backward([qo, ko, vo], cot)
    assert (apply_rope.fwd_launches, apply_rope.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    src = qkv.detach()
    assert torch.equal(qo, rope_reference(
        src[..., :g, :].reshape(b, s, hkv * g, 128), cos, sin,
        positions=pos))
    assert torch.equal(ko, rope_reference(src[..., g, :], cos, sin,
                                          positions=pos))
    assert torch.equal(vo, src[..., g + 1, :]) and vo.is_contiguous()
    dq = rope_reference(cot[0], cos, sin, positions=pos, inverse=True)
    dk = rope_reference(cot[1], cos, sin, positions=pos, inverse=True)
    grad = qkv.grad
    assert torch.equal(grad[..., :g, :].reshape(dq.shape), dq)
    assert torch.equal(grad[..., g, :], dk)
    assert torch.equal(grad[..., g + 1, :], cot[2])


@pytest.mark.parametrize("fused", [False, True])
def test_every_remat_policy_gives_full_step_one(fused):
    """A 2-layer bf16 model of the 700M's width: the loss and the
    gradients under each policy equal ``full``'s, bitwise (the kernels are
    deterministic, and a replay runs the same launches)."""
    from kubeflow_tpu_torch.models.llama import (
        REMAT_POLICIES,
        Llama,
        LlamaConfig,
    )
    from kubeflow_tpu_torch.train.losses import cross_entropy_loss

    g = torch.Generator(device="cuda").manual_seed(45)
    tokens = torch.randint(0, 32000, (2, 513), generator=g, device="cuda")
    kw = dict(vocab_size=32000, embed_dim=2048, num_layers=2, num_heads=16,
              num_kv_heads=8, head_dim=128, mlp_dim=5632, max_seq_len=1024,
              param_dtype="bfloat16", dtype="bfloat16", remat=True,
              fused_qkv=fused, fused_gate_up=fused)
    with torch.device("cuda"):
        model = Llama(LlamaConfig(**kw))
    model.init_weights(torch.Generator(device="cuda").manual_seed(46))
    sd = model.state_dict()
    results = {}
    for policy in REMAT_POLICIES:
        with torch.device("cuda"):
            m = Llama(LlamaConfig(**kw, remat_policy=policy))
        m.load_state_dict(sd)
        logits = m(tokens[:, :-1])
        loss, _ = cross_entropy_loss(logits, tokens[:, 1:],
                                     z_loss_weight=1e-4)
        results[policy] = (loss.detach(), torch.autograd.grad(
            loss, list(m.parameters())))
        del m, logits, loss
    want_loss, want_grads = results["full"]
    for policy, (loss, grads) in results.items():
        assert torch.equal(loss, want_loss), policy
        for a, b in zip(grads, want_grads):
            assert torch.equal(a, b), policy


# K7's staged decode mode: q rotated, k rotated into staging column
# stage_step and v copied into it, in one launch; bitwise its plain
# version, the staging tensors checked whole (only that column changes).
def _rope_stage_case(b, hkv, g, dtype, pdt, seed, fused, C=8):
    from kubeflow_tpu_torch.ops.rope import rope_frequencies

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, 1, hkv, g + 2, 128, generator=gen,
                      device="cuda").to(dtype)
    pos = torch.randint(0, 2048 + 40, (b, 1), generator=gen,
                        device="cuda").to(pdt)
    stage = [torch.randn(b, C, hkv, 128, generator=gen,
                         device="cuda").to(dtype) for _ in range(2)]
    cos, sin = rope_frequencies(128, 2048, theta=500000.0, device="cuda")
    if fused:
        return (qkv,), pos, stage, cos, sin
    q = qkv[..., :g, :].reshape(b, 1, hkv * g, 128).contiguous()
    return ((q, qkv[..., g, :].contiguous(), qkv[..., g + 1, :].contiguous()),
            pos, stage, cos, sin)


def _rope_stage_plain(args, pos, stage, cos, sin, step):
    from kubeflow_tpu_torch.ops.rope import rope_stage_reference

    sk, sv = (t.clone() for t in stage)
    if len(args) == 1:
        (qkv,) = args
        b, _, hkv, g2, d = qkv.shape
        args = (qkv[..., :g2 - 2, :].reshape(b, 1, -1, d), qkv[..., -2, :],
                qkv[..., -1, :])
    q = rope_stage_reference(*args, cos, sin, pos, sk, sv, step)
    return q, sk, sv


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,pdt", [(torch.bfloat16, torch.int32),
                                       (torch.bfloat16, torch.int64),
                                       (torch.float32, torch.int64)])
@pytest.mark.parametrize("b,step", [(8, 0), (8, 5), (48, 7), (1, 3)])
def test_rope_stage_matches_plain_bitwise(b, step, dtype, pdt, fused):
    from kubeflow_tpu_torch.ops.rope import (
        apply_rope,
        rope_stage,
        rope_stage_fused,
    )

    args, pos, stage, cos, sin = _rope_stage_case(b, 8, 4, dtype, pdt, 50,
                                                  fused)
    want_q, want_k, want_v = _rope_stage_plain(args, pos, stage, cos, sin,
                                               step)
    sk, sv = (t.clone() for t in stage)
    before = apply_rope.fwd_launches, apply_rope.stage_launches
    with torch.no_grad():
        q = (rope_stage_fused if fused else rope_stage)(
            *args, cos, sin, pos, sk, sv, step)
    assert (apply_rope.fwd_launches, apply_rope.stage_launches) == (
        before[0] + 1, before[1] + 1)
    assert q.shape == (b, 1, 32, 128) and q.is_contiguous()
    assert torch.equal(q, want_q)
    assert torch.equal(sk, want_k) and torch.equal(sv, want_v)
    others = [c for c in range(sk.shape[1]) if c != step]
    assert torch.equal(sk[:, others], stage[0][:, others])
    assert torch.equal(sv[:, others], stage[1][:, others])


def test_rope_stage_graph_replay_and_deterministic():
    from kubeflow_tpu_torch.ops.rope import rope_stage_fused

    (qkv,), pos, stage, cos, sin = _rope_stage_case(
        8, 8, 4, torch.bfloat16, torch.int32, 51, True)
    with torch.no_grad():
        a = rope_stage_fused(qkv, cos, sin, pos, *stage, 2)
        b = rope_stage_fused(qkv, cos, sin, pos, *stage, 2)
        assert torch.equal(a, b)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            rope_stage_fused(qkv, cos, sin, pos, *stage, 4)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = rope_stage_fused(qkv, cos, sin, pos, *stage, 4)
        qkv.copy_(torch.randn_like(qkv.float()).bfloat16())
        pos.add_(1)
        graph.replay()
        want = _rope_stage_plain((qkv,), pos, stage, cos, sin, 4)
        assert torch.equal(out, want[0])
        assert torch.equal(stage[0], want[1])
        assert torch.equal(stage[1], want[2])


def test_rope_stage_refusals():
    from kubeflow_tpu_torch.ops.rope import (
        apply_rope,
        rope_stage,
        rope_stage_fused,
    )

    (q, k, v), pos, stage, cos, sin = _rope_stage_case(
        8, 8, 4, torch.bfloat16, torch.int64, 52, False)
    before = apply_rope.fwd_launches, apply_rope.stage_launches
    with torch.no_grad():
        for bad in (8, -1, True, 2.0):
            with pytest.raises(ValueError, match="stage_step"):
                rope_stage(q, k, v, cos, sin, pos, *stage, bad)
        # A view whose rows start off the 16-byte grid.
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
        shifted = buf[1:].view(q.shape).copy_(q)
        with pytest.raises(ValueError, match="16-byte"):
            rope_stage(shifted, k, v, cos, sin, pos, *stage, 0)
        buf = torch.empty(stage[0].numel() + 1, dtype=q.dtype,
                          device="cuda")
        with pytest.raises(ValueError, match="16-byte"):
            rope_stage(q, k, v, cos, sin, pos,
                       buf[1:].view(stage[0].shape), stage[1], 0)
        with pytest.raises(ValueError, match="one token"):
            rope_stage(q.expand(8, 2, 32, 128), k, v, cos, sin, pos,
                       *stage, 0)
        with pytest.raises(ValueError, match="stage_value"):
            rope_stage(q, k, v, cos, sin, pos, stage[0], stage[1][:, :, :4],
                       0)
        with pytest.raises(ValueError, match="does not match"):
            rope_stage(q, k, v.float(), cos, sin, pos, *stage, 0)
        qkv = torch.zeros(8, 1, 8, 6, 128, dtype=torch.bfloat16,
                          device="cuda")
        with pytest.raises(ValueError, match="stage_step"):
            rope_stage_fused(qkv, cos, sin, pos, *stage, 9)
    assert (apply_rope.fwd_launches, apply_rope.stage_launches) == before


# K4 with the SwiGLU epilogue: bitwise K4's grouped launch of gate and up
# at the same split followed by K9, gate and up apart or the halves of one
# fused [2F, K] weight; within K4's tolerance of the plain composition.
def _epilogue_operands(m, F, k, seed, fused):
    from kubeflow_tpu_torch.serving.engine import _quantize_leaf

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(2 * F, k, generator=gen, device="cuda") * 0.02
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    if fused:
        q, scale = _quantize_leaf(w, 1)
        return x, (q[:F], scale[:F]), (q[F:], scale[F:])
    return (x, _quantize_leaf(w[:F].contiguous(), 1),
            _quantize_leaf(w[F:].contiguous(), 1))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 9, 16])
def test_int8_swiglu_epilogue_bitwise_k4_then_k9(m, splits, fused):
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.ops import swiglu as sw

    x, gate, up = _epilogue_operands(m, 1040, 4096, 60 + m, fused)
    with torch.no_grad():
        h = il._swiglu_kernel(x, gate, up, None, splits=splits)
        g, u = il._group_kernel(x, [gate, up], None, splits=splits)
        want = sw._fwd_kernel(g, u)
        assert torch.equal(h, want)
        assert torch.equal(h, il._swiglu_kernel(x, gate, up, None,
                                                splits=splits))
    _check_int8(h, il.int8_linear_swiglu_reference(x, gate, up))


@pytest.mark.parametrize("fused", [False, True])
def test_int8_swiglu_epilogue_at_the_decode_shape(fused):
    """llama3-8b's gate/up at M = 8 through the public entry (the
    kernel's own split), one launch counted as K4 and as the epilogue."""
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.ops import swiglu as sw

    x, gate, up = _epilogue_operands(8, 14336, 4096, 61, fused)
    before = (il.int8_linear.launches, il.int8_linear.swiglu_launches,
              sw.swiglu.fwd_launches)
    with torch.no_grad():
        h = il.int8_linear_swiglu(x.view(8, 1, 4096), gate, up)
    assert (il.int8_linear.launches, il.int8_linear.swiglu_launches,
            sw.swiglu.fwd_launches) == (before[0] + 1, before[1] + 1,
                                        before[2])
    assert h.shape == (8, 1, 14336)
    with torch.no_grad():
        g, u = il.int8_linear_group(x, [gate, up])
        assert torch.equal(h.view(8, 14336), sw._fwd_kernel(g, u))
    _check_int8(h.view(8, 14336),
                il.int8_linear_swiglu_reference(x, gate, up))


def test_int8_swiglu_epilogue_graph_replay_and_refusals():
    from kubeflow_tpu_torch.ops import int8_linear as il

    x, gate, up = _epilogue_operands(8, 1024, 1024, 62, False)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            il.int8_linear_swiglu(x, gate, up)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = il.int8_linear_swiglu(x, gate, up)
        x.copy_(torch.randn_like(x.float()).bfloat16())
        graph.replay()
        assert torch.equal(out, il.int8_linear_swiglu(x, gate, up))
        before = il.int8_linear.launches, il.int8_linear.swiglu_launches
        x17, _, _ = _epilogue_operands(17, 1024, 1024, 62, False)
        with pytest.raises(ValueError, match="at most 16 rows"):
            il.int8_linear_swiglu(x17, gate, up)
        _, cols = _int8_group_operands(8, 128)
        with pytest.raises(ValueError, match="per-row scales"):
            il.int8_linear_swiglu(x, gate, (up[0], cols[0][1][:1024]))
        with pytest.raises(ValueError, match="one shape"):
            il.int8_linear_swiglu(x, gate, (up[0][:512], up[1][:512]))
        with pytest.raises(ValueError, match="bf16 x"):
            il.int8_linear_swiglu(x.float(), gate, up)
        assert (il.int8_linear.launches,
                il.int8_linear.swiglu_launches) == before


def test_mlp_decode_rows_take_the_swiglu_epilogue(monkeypatch):
    """An int8-weight Mlp at a decode step's rows (8) makes one K4 launch
    with the epilogue and no K9; at 48 rows, or with K4's products
    followed by K9 forced, the same function through K9: bitwise."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops import int8_linear as il
    from kubeflow_tpu_torch.ops import swiglu as sw
    from kubeflow_tpu_torch.serving.engine import _quantize_int8

    for fused in (False, True):
        cfg = llama.LlamaConfig.tiny(embed_dim=256, mlp_dim=1024,
                                     dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16,
                                     fused_gate_up=fused)
        with torch.device("cuda"):
            model = llama.Llama(cfg)
        model.init_weights(torch.Generator(device="cuda").manual_seed(63))
        _quantize_int8(model, min_size=64)
        mlp = model.layers[0].mlp
        for rows, epilogue in ((8, True), (48, False)):
            x = torch.randn(rows, 1, 256, device="cuda").bfloat16()
            before = (il.int8_linear.launches,
                      il.int8_linear.swiglu_launches, sw.swiglu.fwd_launches)
            with torch.no_grad():
                got = mlp(x)
            assert (il.int8_linear.launches - before[0],
                    il.int8_linear.swiglu_launches - before[1],
                    sw.swiglu.fwd_launches - before[2]) == (
                2, int(epilogue), int(not epilogue))
            with monkeypatch.context() as mp:
                mp.setattr(mlp, "epilogue_weights", lambda x: None)
                with torch.no_grad():
                    assert torch.equal(mlp(x), got)


# ------------------------------------------------- the MoE dispatch (K12-K14)

# (T tokens, E experts, G groups, C capacity): mixtral-8x7b's decode step
# and prefill group, two groups, a group that is not a power of two, and
# the most experts K12 takes.
MOE_CASES = [(8, 8, 1, 4), (4096, 8, 1, 1280), (512, 8, 2, 64),
             (96, 8, 2, 12), (256, 64, 1, 8)]


def _moe_logits(T, E, seed, hot=3.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(T, E, generator=g, device="cuda")
    logits[:, 1] += hot                   # a hot expert: capacity drops
    return logits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,E,G,C", MOE_CASES)
def test_moe_route_matches_plain_bitwise(T, E, G, C, dtype):
    from kubeflow_tpu_torch.ops import moe

    # f32 logits, and the served path's bf16 ones (widened exactly).
    for logits in (_moe_logits(T, E, T + E),
                   _moe_logits(T, E, T + E).bfloat16()):
        before = moe.route.launches
        got = moe.route(logits, G, C, dtype)
        assert moe.route.launches == before + 1
        want = moe.route_reference(logits, G, C, dtype)
        for name, a, b in zip(moe.Routing._fields, got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        S = E * G * C
        assert int((got.dest1 == S).sum()) > 0          # drops happened
        for a, b in zip(got, moe.route(logits, G, C, dtype)):
            assert torch.equal(a, b)


def test_moe_route_ties_and_a_lone_token_group():
    from kubeflow_tpu_torch.ops import moe

    logits = torch.round(_moe_logits(64, 8, 5, hot=0.0))   # tied gates
    for G, C in ((1, 16), (64, 4)):
        for a, b in zip(moe.route(logits, G, C, torch.bfloat16),
                        moe.route_reference(logits, G, C, torch.bfloat16)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,E,G,C", MOE_CASES[:3])
def test_moe_gather_and_combine_match_plain_bitwise(T, E, G, C, dtype):
    from kubeflow_tpu_torch.ops import moe

    M = 4096 if T <= 512 else 1024
    r = moe.route(_moe_logits(T, E, 7), G, C, dtype)
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(T, M, generator=g, device="cuda").to(dtype)
    before = moe.gather_rows.launches, moe.combine_rows.launches
    ein = moe.gather_rows(x, r.slot_tok, r.slot_valid)
    assert torch.equal(ein, moe.gather_rows_reference(x, r.slot_tok,
                                                      r.slot_valid))
    y = torch.randn(E * G * C, M, generator=g, device="cuda").to(dtype)
    out = moe.combine_rows(y, r.g1, r.g2, r.dest1, r.dest2)
    assert out.dtype == dtype
    assert torch.equal(out, moe.combine_rows_reference(y, r.g1, r.g2,
                                                       r.dest1, r.dest2))
    assert (moe.gather_rows.launches, moe.combine_rows.launches) == (
        before[0] + 1, before[1] + 1)


def test_moe_kernels_replay_in_a_graph_and_refuse():
    from kubeflow_tpu_torch.ops import moe

    logits = _moe_logits(8, 8, 9)
    x = torch.randn(8, 4096, device="cuda").bfloat16()

    def dispatch():
        r = moe.route(logits, 1, 4, torch.bfloat16)
        y = moe.gather_rows(x, r.slot_tok, r.slot_valid) * 2
        return moe.combine_rows(y, r.g1, r.g2, r.dest1, r.dest2)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dispatch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dispatch()
    logits.copy_(_moe_logits(8, 8, 10))
    x.copy_(torch.randn_like(x.float()).bfloat16())
    graph.replay()
    assert torch.equal(out, dispatch())
    before = (moe.route.launches, moe.gather_rows.launches,
              moe.combine_rows.launches)
    with pytest.raises(ValueError, match="E <= 64"):
        moe.route(torch.zeros(8, 65, device="cuda"), 1, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 logits"):
        moe.route(logits.half(), 1, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of groups"):
        moe.route(logits, 3, 4, torch.bfloat16)
    r = moe.route_reference(logits, 1, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe.gather_rows(x[:, :100], r.slot_tok, r.slot_valid)
    with pytest.raises(ValueError, match="slot_valid"):
        moe.gather_rows(x, r.slot_tok, r.slot_valid.float())
    with pytest.raises(NotImplementedError, match="backward"):
        moe.gather_rows(x.float().requires_grad_(), r.slot_tok,
                        r.slot_valid.float())
    assert (moe.route.launches, moe.gather_rows.launches,
            moe.combine_rows.launches) == before


# ENGINE_PROMPTS reordered: the first admission prefills three prompts of
# one bucket, padded to four rows (k-padding), beside one of the other.
MOE_PROMPTS = [ENGINE_PROMPTS[i] for i in (0, 2, 4, 1, 3, 5)]


@pytest.mark.parametrize("paged", [False, True])
def test_mixtral_engine_graph_tokens_equal_eager(paged):
    """A small Mixtral of K1/K3's head_dim on the card, staged, dense or
    paged, its graphs against its eager path with a k-padded prefill (the
    pad rows route apart from row 0, and only the last row naming a slot
    may write it): greedy tokens equal, and K12-K14 once a layer a
    forward pass (graph replays counted)."""
    from kubeflow_tpu_torch.models.mixtral import Mixtral, MixtralConfig
    from kubeflow_tpu_torch.ops import moe
    from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
    from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

    model_kw, serve_kw = (({"paged_kv_blocks": 64}, {"kv_blocks": 64,
                                                     "kv_block_size": 16})
                          if paged else ({}, {}))
    cfg = MixtralConfig.tiny(vocab_size=512, embed_dim=256, num_heads=4,
                             num_kv_heads=2, head_dim=64, mlp_dim=512,
                             max_seq_len=256, decode_staging=4,
                             capacity_factor=1.0, **model_kw)
    with torch.device("cuda"):
        model = Mixtral(cfg)
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    out = {}
    with torch.no_grad():
        for eager in (True, False):
            eng = ServingEngine(model, ServingConfig(
                max_batch=4, max_len=256, prefill_buckets=(16, 32),
                decode_chunk=4, pipeline_depth=2, **serve_kw),
                device="cuda", registry=MetricsRegistry(), _eager=eager)
            if not eager:
                eng.warmup(16)
            groups = []
            k_pad = eng._k_pad
            eng._k_pad = lambda n: groups.append(n) or k_pad(n)
            eng.prefill_dispatches = eng.extend_dispatches = 0
            eng.decode_dispatches = 0
            moe.route.launches = moe.gather_rows.launches = 0
            moe.combine_rows.launches = 0
            out[eager] = _serve(eng, MOE_PROMPTS)
            assert 3 in groups                    # one pad row
            passes = (4 * eng.decode_dispatches + eng.prefill_dispatches
                      + eng.extend_dispatches)
            assert (moe.route.launches, moe.gather_rows.launches,
                    moe.combine_rows.launches) == (2 * passes,) * 3
    assert out[False] == out[True]
    assert [len(t) for t in out[False]] == [n for _, n in MOE_PROMPTS]

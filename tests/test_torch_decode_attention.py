"""The port's plain decode attention and quantize_kv_rows against the JAX
model's, on the same seeded numpy inputs.

- ``decode_attention_reference`` unstaged against the JAX decode step's
  masked ``mha_reference`` over the cache (ragged cache_index, idle slots
  past max_len, the int8 cache with its scales), and staged against
  ``_staged_decode_attention`` at every stage_step.
- Tolerances: f32 atol = rtol = 1e-5 (same algorithm, other summation
  order); bf16 max |got - want| <= 2e-2 x max |want| (the two frameworks
  round bf16 at other places inside their fused products).
- ``quantize_kv_rows`` bitwise: absmax / 127 and the division are the same
  f32 operations, and torch.round and jnp.round both round half to even.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.ops.attention import mha_reference as jax_mha_reference
from kubeflow_tpu_torch.models.llama import quantize_kv_rows
from kubeflow_tpu_torch.ops.attention import decode_attention_reference
from kubeflow_tpu_torch.ops.decode_attention import (
    CHUNK_ROWS,
    MAX_CLUSTER,
    decode_attention,
    split_plan,
)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, H, HKV, D, L, C = 4, 8, 2, 16, 40, 4


def _check(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _inputs(seed: int, sq: int = 1):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, sq, H, D).astype(np.float32)
    k = rs.randn(B, L, HKV, D).astype(np.float32)
    v = rs.randn(B, L, HKV, D).astype(np.float32)
    return q, k, v


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _int8_cache(k: np.ndarray):
    """int8 rows and f32 scales of ``k`` (the JAX function's), for both."""
    k8, ks = jllama.quantize_kv_rows(jnp.asarray(k))
    k8, ks = np.array(k8), np.array(ks)
    return (jnp.asarray(k8), jnp.asarray(ks), torch.from_numpy(k8),
            torch.from_numpy(ks))


# Pre-write indices of the JAX step: ragged, a fresh row, and an idle slot
# far past max_len (its index grows every step, and it sees every row).
RAGGED = np.array([0, 7, L - 1, 3 * L], np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("sq", [1, 3])
def test_unstaged_matches_jax_masked_mha(dtype, sq):
    q, k, v = _inputs(0, sq)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    q_pos = RAGGED[:, None] + np.arange(sq)[None, :]
    mask = np.arange(L)[None, None, :] <= q_pos[:, :, None]
    want = jax_mha_reference(jq, jk, jv, mask=jnp.asarray(mask)[:, None])
    got = decode_attention_reference(
        tq, tk, tv, torch.from_numpy(RAGGED + sq))    # post-write index
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_cache_matches_jax(dtype):
    q, k, v = _inputs(1)
    jq, tq = _pair(q, dtype)
    jk8, jks, tk8, tks = _int8_cache(k)
    jv8, jvs, tv8, tvs = _int8_cache(v)
    mask = np.arange(L)[None, None, :] <= RAGGED[:, None, None]
    want = jax_mha_reference(jq, jk8, jv8, mask=jnp.asarray(mask)[:, None],
                             k_scale=jks, v_scale=jvs)
    got = decode_attention_reference(tq, tk8, tv8, torch.from_numpy(
        RAGGED + 1), k_scale=tks, v_scale=tvs)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("stage_step", range(C))
def test_staged_matches_jax(dtype, quant, stage_step):
    q, k, v = _inputs(2)
    rs = np.random.RandomState(3)
    sk = rs.randn(B, C, HKV, D).astype(np.float32)
    sv = rs.randn(B, C, HKV, D).astype(np.float32)
    (jq, tq), (jsk, tsk), (jsv, tsv) = (_pair(x, dtype) for x in (q, sk, sv))
    idx = np.array([0, 5, L - 3, 2 * L], np.int32)     # flushed lengths
    if quant:
        jk, jks, tk, tks = _int8_cache(k)
        jv, jvs, tv, tvs = _int8_cache(v)
    else:
        (jk, tk), (jv, tv) = _pair(k, dtype), _pair(v, dtype)
        jks = jvs = tks = tvs = None
    want = jllama._staged_decode_attention(
        JaxLlamaConfig.tiny(), jq, jnp.asarray(idx), stage_step, jk, jv,
        jsk, jsv, jks, jvs)
    got = decode_attention_reference(
        tq, tk, tv, torch.from_numpy(idx), k_scale=tks, v_scale=tvs,
        stage_key=tsk, stage_value=tsv, stage_step=stage_step)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_kv_rows_bitwise(dtype):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 2, 16).astype(np.float32) * 4
    x[0, 0, 0] = 0.0                    # an all-zero row: the 1e-8 floor
    x[1, 2, 1, :4] = [63.5, -63.5, 0.5, 127.0]   # ties at half steps
    jx, tx = _pair(x, dtype)
    jq, js = jllama.quantize_kv_rows(jx)
    tq, ts = quantize_kv_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = _inputs(5)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    idx = torch.from_numpy(RAGGED + 1)
    before = decode_attention.launches
    got = decode_attention(tq, tk, tv, idx)
    assert torch.equal(got, decode_attention_reference(tq, tk, tv, idx))
    assert decode_attention.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("max_len", [1, 17, 64, 1024, 4096, 8192, 10_000])
def test_split_plan_covers_the_cache(max_len):
    blocks = split_plan(max_len)
    assert 1 <= blocks <= MAX_CLUSTER
    chunks = -(-max_len // CHUNK_ROWS)
    assert blocks == min(chunks, MAX_CLUSTER)  # no block idle at a full cache
    # The kernel's split of a full cache: the blocks' chunk ranges tile
    # [0, chunks) in order and differ by at most one chunk.
    per, extra = divmod(chunks, blocks)
    starts = [r * per + min(r, extra) for r in range(blocks)]
    counts = [per + (r < extra) for r in range(blocks)]
    assert starts[0] == 0 and starts[-1] + counts[-1] == chunks
    assert all(a + n == c for a, n, c in zip(starts, counts, starts[1:]))
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1

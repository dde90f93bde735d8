"""The port's physically paged KV pool against the JAX package's.

- The pool operations (``ops/paged_attention.py``) on the same numpy
  inputs: row addressing and its scratch redirects, the scatter/gather
  round trip and the page copy bitwise; the gathered decode attention
  within 1e-5 of JAX's in f32 (the two frameworks sum the products in
  their own order).
- The serving engine on llama-tiny in f32, projections scaled x8 (as in
  tests/test_torch_serving.py): the port's paged engine gives the JAX
  paged engine's greedy tokens on the mixed trace of the JAX package's
  paged smoke (block size 8, max_len 64, 32 blocks, 4 slots), and the
  port's dense engine's tokens, bitwise, on that trace, on chunked
  prefill and on the int8 staged cache. Copy-on-write sharing is held
  non-vacuous (shared references and forks happen) with the allocator's
  conservation clean after every drain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import Llama as JaxLlama
from kubeflow_tpu.models import LlamaConfig as JaxLlamaConfig
from kubeflow_tpu.ops import paged_attention as jpa
from kubeflow_tpu.serving import ServingConfig as JaxServingConfig
from kubeflow_tpu.serving import ServingEngine as JaxServingEngine
from kubeflow_tpu.utils.monitoring import MetricsRegistry as JaxRegistry
from kubeflow_tpu_torch.models import Llama, LlamaConfig
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.ops import paged_attention as pa
from kubeflow_tpu_torch.ops.attention import decode_attention_reference
from kubeflow_tpu_torch.ops.decode_attention import decode_attention
from kubeflow_tpu_torch.serving import ServingConfig, ServingEngine
from kubeflow_tpu_torch.utils.monitoring import MetricsRegistry

# The suite runs in several pytest-xdist workers that share the cores:
# one intra-op thread a worker (process-wide) keeps PyTorch's pools from
# oversubscribing them.
torch.set_num_threads(1)

BS, MAX_LEN = 8, 64
KV_BLOCKS = 4 * (MAX_LEN // BS)
MIXED_TRACE = [[7, 3, 9, 1, 4], [2] * 17, [250, 100, 3],
               [11, 22, 33, 44, 55, 66, 77]]


# ------------------------------------------------------------- the ops

def test_physical_rows_and_redirects_match_jax():
    scratch = pa.scratch_block_id(8)
    tables = np.asarray([[5, 2], [7, scratch]], np.int32)
    positions = np.asarray([[0, 3, 4, 7], [1, 4, 9, 0]], np.int32)
    valid = np.asarray([[True] * 4, [True, True, True, False]])
    got = pa.physical_rows(torch.from_numpy(tables),
                           torch.from_numpy(positions), 4, num_blocks=8,
                           valid=torch.from_numpy(valid))
    want = jpa.physical_rows(jnp.asarray(tables), jnp.asarray(positions), 4,
                             num_blocks=8, valid=jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Slot 1's scratch-padded column, a position past the table and an
    # invalid one all land on the scratch page.
    assert got[1].tolist() == [29, 32, 32, 32]
    assert pa.pool_shape(32, 8, 2, 16) == jpa.pool_shape(32, 8, 2, 16)
    assert pa.pool_shape(32, 8, 2, 16, trailing=1) == (33, 8, 2, 1)


def test_scatter_gather_round_trip_and_copy_block():
    rng = np.random.default_rng(0)
    tables = np.asarray([[4, 1], [0, 3]], np.int32)
    positions = np.tile(np.arange(8)[None], (2, 1))
    vals = rng.normal(size=(2, 8, 2, 3)).astype(np.float32)
    pool = torch.zeros(pa.pool_shape(6, 4, 2, 3))
    rows = pa.physical_rows(torch.from_numpy(tables),
                            torch.from_numpy(positions), 4, num_blocks=6)
    assert pa.scatter_kv_rows(pool, rows, torch.from_numpy(vals)) is pool
    np.testing.assert_array_equal(
        pa.gather_kv_pages(pool, torch.from_numpy(tables), 4).numpy(), vals)
    jpool = jpa.scatter_kv_rows(
        jnp.zeros(jpa.pool_shape(6, 4, 2, 3)),
        jpa.physical_rows(jnp.asarray(tables), jnp.asarray(positions), 4,
                          num_blocks=6), jnp.asarray(vals))
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
    before = pool.clone()
    pa.copy_block(pool, 1, 5)
    np.testing.assert_array_equal(pool.numpy(),
                                  np.asarray(jpa.copy_block(
                                      jnp.asarray(before.numpy()), 1, 5)))
    assert torch.equal(pool[5], before[1])


def _paged_inputs(seed, int8=False):
    rng = np.random.default_rng(seed)
    B, H, Hkv, D, bs, nblk = 2, 4, 2, 16, 4, 6
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kp = rng.normal(size=pa.pool_shape(nblk, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=pa.pool_shape(nblk, bs, Hkv, D)).astype(np.float32)
    scales = {}
    if int8:
        kp = np.round(kp * 40).clip(-127, 127).astype(np.int8)
        vp = np.round(vp * 40).clip(-127, 127).astype(np.int8)
        scales = {
            f"{n}_scale_pool": rng.uniform(
                0.01, 0.05, size=pa.pool_shape(nblk, bs, Hkv, D,
                                               trailing=1)).astype(np.float32)
            for n in ("key", "value")}
    tables = np.asarray([[5, 0], [2, 4]], np.int32)
    q_pos = np.asarray([[5], [2 * bs - 1]], np.int32)    # mid-page, full
    return q, kp, vp, tables, q_pos, bs, scales


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_attention_matches_jax(int8):
    q, kp, vp, tables, q_pos, bs, scales = _paged_inputs(1, int8)
    got = pa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(q_pos), bs,
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(q_pos), bs, **{k: jnp.asarray(v)
                                   for k, v in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_attention_by_table_is_the_dense_call_on_the_cpu():
    """The wrapper's CPU path with a table: the plain version over the
    gathered rows, bitwise; staged too."""
    q, kp, vp, tables, q_pos, bs, _ = _paged_inputs(2)
    q, kp, vp, tables = map(torch.from_numpy, (q, kp, vp, tables))
    lens = torch.from_numpy(q_pos[:, 0] + 1)
    k = pa.gather_kv_pages(kp, tables, bs)
    v = pa.gather_kv_pages(vp, tables, bs)
    got = decode_attention(q, kp, vp, lens, block_tables=tables,
                           block_size=bs)
    assert torch.equal(got, decode_attention_reference(q, k, v, lens))
    assert torch.equal(got, pa.paged_decode_attention(
        q, kp, vp, tables, torch.from_numpy(q_pos), bs))
    # Staged: two rows staged (step 1), so the cache holds two fewer.
    rng = np.random.default_rng(3)
    sk, sv = (torch.from_numpy(rng.normal(size=(2, 4, 2, 16)).astype(
        np.float32)) for _ in range(2))
    got = decode_attention(q, kp, vp, lens - 2, stage_key=sk, stage_value=sv,
                           stage_step=1, block_tables=tables, block_size=bs)
    assert torch.equal(got, decode_attention_reference(
        q, k, v, lens - 2, stage_key=sk, stage_value=sv, stage_step=1))
    assert torch.equal(got, pa.paged_decode_attention(
        q, kp, vp, tables, torch.from_numpy(q_pos), bs, stage_key=sk,
        stage_value=sv, stage_step=1))


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def shared():
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, max_seq_len=128)
    jmodel = JaxLlama(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    params = jax.tree.map(lambda x: x * 8 if x.ndim >= 2 else x, params)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=128)
    return jmodel, params, tcfg, llama_params_from_jax(params, tcfg)


def _paged_kw(paged, blocks=KV_BLOCKS):
    if not paged:
        return {}, {}
    return ({"paged_kv_blocks": blocks, "paged_kv_block_size": BS},
            {"kv_blocks": blocks, "kv_block_size": BS})


def port_engine(shared, paged, model_kw=None, registry=None, blocks=KV_BLOCKS,
                **kw):
    _, _, tcfg, sd = shared
    mkw, skw = _paged_kw(paged, blocks)
    model = Llama(dataclasses.replace(tcfg, **{**(model_kw or {}), **mkw}))
    model.load_state_dict(sd)
    return ServingEngine(
        model, ServingConfig(param_dtype="", max_batch=4, max_len=MAX_LEN,
                             **skw, **kw),
        device="cpu", registry=registry or MetricsRegistry())


def run_trace(eng, prompts, n_new=8, **req):
    rids = [eng.submit(list(p), max_new_tokens=n_new, **req)
            for p in prompts]
    eng.run()
    return [eng.result(r).tokens for r in rids]


def assert_drained(eng):
    eng.blocks.check_conservation()
    assert eng.blocks.blocks_live == 0
    assert eng.blocks.blocks_free == eng.blocks.total_blocks
    assert (eng._block_tables == eng._scratch_block).all()


def test_paged_engine_matches_the_jax_paged_engine(shared):
    jmodel, params, _, _ = shared
    mkw, skw = _paged_kw(True)
    jeng = JaxServingEngine(
        JaxLlama(dataclasses.replace(jmodel.cfg, **mkw)), params,
        JaxServingConfig(param_dtype="", max_batch=4, max_len=MAX_LEN,
                         **skw), registry=JaxRegistry())
    eng = port_engine(shared, True)
    assert run_trace(eng, MIXED_TRACE) == run_trace(jeng, MIXED_TRACE)
    assert_drained(eng)


SCENARIOS = {
    "mixed": ({}, {}, MIXED_TRACE, 8),
    # The served configuration's shape: int8 cache, staged decode, chunks
    # of 4, two chunks in flight.
    "int8_staged": ({"kv_cache_dtype": "int8", "decode_staging": 4},
                    {"decode_chunk": 4, "pipeline_depth": 2}, MIXED_TRACE, 8),
    # A prompt past the largest bucket: the paged extend.
    "chunked": ({}, {"prefill_buckets": (16, 32)},
                [[(5 * i + 2) % 250 for i in range(50)], [4, 5, 6]], 6),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_paged_engine_tokens_equal_dense(shared, name):
    mkw, skw, trace, n_new = SCENARIOS[name]
    dense = run_trace(port_engine(shared, False, mkw, **skw), trace, n_new)
    eng = port_engine(shared, True, mkw, **skw)
    assert run_trace(eng, trace, n_new) == dense
    assert_drained(eng)
    # The pool, not max_batch x max_len rows, is the cache.
    assert eng._cache[0]["cached_key"].shape[:2] == (KV_BLOCKS + 1, BS)


def test_identical_prompts_share_fork_and_keep_tokens(shared):
    """17 tokens with 8-token blocks: blocks 0-1 shared whole, block 2 a
    shared partial tail that each sharer's first decode write forks."""
    reg = MetricsRegistry()
    trace = [[(7 * i + 3) % 250 for i in range(17)]] * 4
    dense = run_trace(port_engine(shared, False), trace, 10)
    eng = port_engine(shared, True, registry=reg)
    assert run_trace(eng, trace, 10) == dense
    assert eng.blocks.shared_refs_total >= 3
    assert eng.blocks.cow_copies_total >= 3 and eng.cow_copies >= 3
    assert_drained(eng)
    load = eng.load()
    assert load["kv_paged"] is True and load["kv_blocks_shared"] == 0
    assert load["kv_cow_copies_total"] == eng.blocks.cow_copies_total
    assert reg.counter("kftpu_serving_kv_cow_copies_total",
                       "").value() == eng.cow_copies


def test_fork_covers_the_write_at_the_tail_pages_last_row(shared):
    """A 15-token prompt's first decode write lands at position 15, the
    last row of the shared tail block: the fork must come before it. The
    JAX engine forks from the dispatch position (16, the next block) and
    lets two sequences write into one page; under sampling their tokens
    then leave the dense engine's. The port's match it."""
    trace = [[(7 * i + 3) % 250 for i in range(15)]] * 4
    kw = dict(decode_chunk=4, pipeline_depth=2)
    dense = run_trace(port_engine(shared, False, **kw), trace, 10,
                      temperature=1.0)
    eng = port_engine(shared, True, **kw)
    assert run_trace(eng, trace, 10, temperature=1.0) == dense
    assert eng.blocks.cow_copies_total >= 3
    assert_drained(eng)


def test_block_aligned_prefix_shares_without_fork(shared):
    head = [9, 8, 7, 6, 5, 4, 3, 2]                 # exactly one block
    trace = [head + [100 + i] for i in range(3)]
    dense = run_trace(port_engine(shared, False), trace, 6)
    eng = port_engine(shared, True)
    assert run_trace(eng, trace, 6) == dense
    assert eng.blocks.shared_refs_total >= 2
    assert eng.blocks.cow_copies_total == 0
    assert_drained(eng)


def test_sharers_prefill_leaves_the_holders_pages_alone(shared):
    """A request sharing a live holder's prefix writes none of its rows: the
    holder's pages keep their bytes through the sharer's prefill, and the
    sharer reads them."""
    head = [(3 * i + 1) % 250 for i in range(16)]   # two whole blocks
    eng = port_engine(shared, True)
    with torch.no_grad():
        first = eng.submit(head + [5, 6, 7], max_new_tokens=12)
        eng.step()                                   # holder prefilled
        pages = eng.blocks.table(first)[:2]
        pool = eng._cache[0]["cached_key"]
        before = pool[pages].clone()
        pool[pages] += 0.5          # marks: a rewrite would replace them
        marked = pool[pages].clone()
        second = eng.submit(head + [8, 9], max_new_tokens=4)
        eng._admit()
        assert eng.blocks.table(second)[:2] == pages
        assert torch.equal(pool[pages], marked)
        pool[pages] = before
        eng.run()
    dense = port_engine(shared, False)
    assert [eng.result(r).tokens for r in (first, second)] == run_trace(
        dense, [head + [5, 6, 7]], 12) + run_trace(dense, [head + [8, 9]], 4)
    assert_drained(eng)


def test_sharing_lifts_the_batch_a_pool_holds(shared):
    """Nine blocks; each request needs three (17 + 6 tokens). Without
    sharing three fit; with the two shared head blocks counted once (and
    the fork reserve held back) at least three run at once and all four
    finish."""
    prompt = [(3 * i + 1) % 250 for i in range(17)]
    eng = port_engine(shared, True, blocks=9)
    for _ in range(4):
        eng.submit(list(prompt), max_new_tokens=6)
    with torch.no_grad():
        eng._admit()
        assert eng.active_slots >= 3
        assert eng.blocks.table_refs > eng.blocks.blocks_live
        res = eng.run()
    assert len(res) == 4 and all(len(r.tokens) == 6 for r in res)
    assert_drained(eng)


def test_paged_geometry_is_checked(shared):
    _, _, tcfg, sd = shared
    model = Llama(dataclasses.replace(tcfg, paged_kv_blocks=KV_BLOCKS,
                                      paged_kv_block_size=BS))
    cases = [(dict(max_len=60, kv_blocks=KV_BLOCKS, kv_block_size=BS),
              "divisible"),
             (dict(max_len=MAX_LEN, kv_blocks=KV_BLOCKS, kv_block_size=16),
              "kv_block_size"),
             (dict(max_len=MAX_LEN, kv_blocks=KV_BLOCKS // 2,
                   kv_block_size=BS), "paged_kv_blocks")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            ServingEngine(model, ServingConfig(max_batch=4, **kw),
                          device="cpu", registry=MetricsRegistry())
    scanned = Llama(dataclasses.replace(tcfg, paged_kv_blocks=KV_BLOCKS,
                                        paged_kv_block_size=BS,
                                        scan_layers=True))
    with pytest.raises(ValueError, match="scan_layers"):
        ServingEngine(scanned, ServingConfig(max_batch=4, max_len=MAX_LEN,
                                             kv_blocks=KV_BLOCKS,
                                             kv_block_size=BS),
                      device="cpu", registry=MetricsRegistry())
    with pytest.raises(ValueError, match="paged_kv_block_size"):
        Llama(dataclasses.replace(tcfg, paged_kv_blocks=4,
                                  paged_kv_block_size=0))

"""The physically paged KV pool: its layout, its row writes and its plain
decode attention, the port of kubeflow_tpu.ops.paged_attention.

A dense decode cache holds ``[B, max_len, Hkv, D]`` rows per layer,
``max_batch x max_len`` rows resident whether a sequence uses them or not.
The paged cache is ONE pool per layer,

    ``[kv_blocks + 1, block_size, Hkv, D]``

shared by every slot. Each sequence maps its logical positions onto pool
pages through a **block table** ``[B, max_blocks]`` of physical block ids
(``serving/blocks.py`` allocates them; copy-on-write prefix sharing maps
common prompt heads to the SAME page), so shrinking ``kv_blocks`` shrinks
device memory, not only admission.

Layout contract (the JAX package's):

- logical position ``p`` of slot ``b`` lives at pool row
  ``table[b, p // block_size] * block_size + p % block_size``;
- physical block ``kv_blocks`` (the LAST one) is the **scratch page**:
  writes that must go nowhere (idle slots, prefill pad columns past a
  row's length, positions past a table's allocated span) land there, so
  the captured steps keep static shapes without touching a live page.
  Nothing reads scratch rows except behind the live-length mask.

Exactness contract: the gather reproduces dense position order
``[0, max_blocks * block_size)``. Junk rows differ from the dense cache's
junk, but every junk column is masked before the softmax in both paths, so
the output is bitwise the dense one's when ``max_len == max_blocks *
block_size`` (the engine requires ``max_len % block_size == 0``).

On the card, decode attention does not gather: K3 reads the pool in place
through the table (``ops/decode_attention.py``, ``block_tables=``). The
functions here are the plain versions: the CPU path, and what the card
holds K3's paged mode against. The row writes are capture-safe (no host
read, in place on a flat view).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kubeflow_tpu_torch.ops.attention import decode_attention_reference


def pool_shape(kv_blocks: int, block_size: int, num_kv_heads: int,
               head_dim: int, *, trailing: int = 0) -> Tuple[int, ...]:
    """Physical pool shape: ``kv_blocks`` live pages plus the trailing
    scratch page. ``trailing`` overrides the last axis (1 for the f32 scale
    pools of the int8 cache, head_dim for K/V)."""
    return (int(kv_blocks) + 1, int(block_size), int(num_kv_heads),
            int(trailing) if trailing else int(head_dim))


def scratch_block_id(kv_blocks: int) -> int:
    """Physical id of the scratch page (always the pool's last block)."""
    return int(kv_blocks)


def physical_rows(tables: torch.Tensor, positions: torch.Tensor,
                  block_size: int, *, num_blocks: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat pool-row index [B, S] (int64) of each logical position.

    tables: [B, max_blocks] physical block ids (scratch-padded);
    positions: [B, S] logical positions; valid: optional [B, S] bool —
    False rows redirect to row 0 of the scratch page. Positions past the
    table width (or negative) redirect too, so a speculative decode write
    past a sequence's allocated span never touches another sequence's
    pages."""
    bs = int(block_size)
    positions = positions.long()
    blk = torch.div(positions, bs, rounding_mode="floor")
    off = positions - blk * bs
    in_table = (blk >= 0) & (blk < tables.shape[1])
    blk_safe = blk.clamp(0, tables.shape[1] - 1)
    rows = torch.gather(tables.long(), 1, blk_safe) * bs + off
    ok = in_table if valid is None else in_table & valid
    scratch_row = scratch_block_id(num_blocks) * bs
    return torch.where(ok, rows, torch.full_like(rows, scratch_row))


def gather_kv_pages(pool: torch.Tensor, tables: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Each slot's pages in dense position order: pool [P + 1, block_size,
    Hkv, t], tables [B, max_blocks] -> [B, max_blocks * block_size, Hkv,
    t] (a copy)."""
    B, nb = tables.shape
    g = pool.index_select(0, tables.reshape(-1).long())
    return g.reshape(B, nb * int(block_size), *pool.shape[2:])


def paged_gather_bytes(*, num_layers: int, batch: int,
                       blocks_per_seq: int, block_size: int,
                       num_kv_heads: int, head_dim: int,
                       dtype_bytes: int = 2) -> int:
    """Device bytes one decode step would pay to gather the pool into dense
    order before the attention: K and V pools per layer, ``batch *
    blocks_per_seq * block_size`` rows each of ``num_kv_heads * head_dim *
    dtype_bytes``, read once from the pool and written once to the
    gathered copy (x2 for K and V, x2 for read and write). K3's paged mode
    reads the pool in place and pays none of it."""
    rows = int(batch) * int(blocks_per_seq) * int(block_size)
    row_bytes = int(num_kv_heads) * int(head_dim) * int(dtype_bytes)
    return int(num_layers) * rows * row_bytes * 2 * 2


def scatter_kv_rows(pool: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """Write per-position rows into the pool IN PLACE and return it. rows:
    [B, S] flat pool-row ids (:func:`physical_rows`); values: [B, S, Hkv,
    t], cast to the pool's dtype. Duplicate ids may only carry rows that
    are never read (the scratch page): which write lands last is not
    defined on the card."""
    flat = pool.view(-1, *pool.shape[2:])
    flat.index_copy_(0, rows.reshape(-1),
                     values.reshape(-1, *values.shape[2:]).to(pool.dtype))
    return pool


def copy_block(pool: torch.Tensor, src_block, dst_block) -> torch.Tensor:
    """Copy physical page ``src_block`` to ``dst_block`` in place (the copy
    half of copy-on-write: a writer forking a shared page gets its current
    rows, which it must keep attending over, before its first write
    lands) and return the pool."""
    pool[int(dst_block)].copy_(pool[int(src_block)])
    return pool


def gather_cache(tables: torch.Tensor, block_size: int, key_pool, value_pool,
                 key_scale_pool=None, value_scale_pool=None):
    """(k, v, k_scale, v_scale) of the pools in dense position order; the
    scales stay None for a bf16 pool."""
    def g(pool):
        return (None if pool is None
                else gather_kv_pages(pool, tables, block_size))

    return (g(key_pool), g(value_pool), g(key_scale_pool),
            g(value_scale_pool))


def paged_decode_attention(
    q: torch.Tensor,
    key_pool: torch.Tensor,
    value_pool: torch.Tensor,
    tables: torch.Tensor,
    q_positions: torch.Tensor,
    block_size: int,
    *,
    key_scale_pool: Optional[torch.Tensor] = None,
    value_scale_pool: Optional[torch.Tensor] = None,
    stage_key: Optional[torch.Tensor] = None,
    stage_value: Optional[torch.Tensor] = None,
    stage_step: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention with the KV context gathered by block table, in
    plain PyTorch.

    q: [B, S, H, D]; key/value_pool: [kv_blocks + 1, block_size, Hkv, D]
    (int8 with the f32 scale pools [.., 1]); tables: [B, max_blocks];
    q_positions: [B, S] absolute positions of the query rows, consecutive
    along S (each slot's cache_index onwards). Query row i attends the
    gathered positions ``<= q_positions[:, i]``; junk pages (scratch,
    another sequence's rows, past the live length) never reach the
    softmax. Staged (``stage_key``/``stage_value`` [B, C, Hkv, D], S ==
    1): the query sits at position flushed + ``stage_step``; the cache
    holds the flushed rows and staging rows ``0..stage_step`` the rest.

    Gathers, then runs :func:`~kubeflow_tpu_torch.ops.attention.
    decode_attention_reference`, the dense cache's plain attention (the
    JAX package's mha_reference and _staged_decode_attention)."""
    k, v, ks, vs = gather_cache(tables, block_size, key_pool, value_pool,
                                key_scale_pool, value_scale_pool)
    seen = q_positions[:, -1].long() + 1
    if stage_key is not None:
        seen = seen - (int(stage_step) + 1)
    return decode_attention_reference(
        q, k, v, seen, k_scale=ks, v_scale=vs, stage_key=stage_key,
        stage_value=stage_value, stage_step=stage_step)

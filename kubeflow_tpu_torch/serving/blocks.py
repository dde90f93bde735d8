"""Paged KV-cache block allocator: the capacity ledger of the decode loop.

A copy of kubeflow_tpu.serving.blocks (the port imports nothing of the
JAX package). The dense engine uses it for admission gating and load()
reports; a paged engine's tables from it address the physical pool
(``ops/paged_attention.py``), so its ledger and the pool are the same
blocks.

The engine's KV memory is carved into fixed-size blocks
(``block_size`` token positions each). Every admitted sequence holds a
**block table** — the list of block ids backing its KV rows — allocated
from one free list at admission and returned at retirement. Batch
capacity is therefore bounded by *total KV blocks against actual
per-request demand* (prompt + requested decode length), not by
``max_batch × max_len``: a fleet of short requests packs many sequences
into the same block budget one long request would monopolise.

Accounting follows the goodput-ledger discipline (obs/goodput.py): every
count is an integer, and the conservation invariant

    blocks_allocated_total == blocks_freed_total + blocks_live

is checked structurally — ``check_conservation`` additionally proves the
free list and the live tables partition the block id space exactly
(no block leaked, none both free and live).
A double free or a free of an unknown sequence raises
``BlockAccountingError`` instead of silently corrupting the free list:
use-after-free across the retire/admit race is an invariant violation,
never a shrug.

Blocks are **refcounted** for copy-on-write prefix sharing:
sequences whose prompts share a block-aligned prefix map the shared
leading blocks to the SAME physical block ids (``alloc(..., shared=)``),
so N sessions over one system prompt pin the prefix pages once. A write
into a shared block must fork it first (``write_fork``), which claims a
fresh physical block for the writer and decrefs the original. The
ledger distinguishes *physical* events (pops from / returns to the free
list — what HBM sees) from *logical* references (table entries):
``blocks_live`` is unique physical blocks, ``table_refs`` is the sum of
table lengths, and ``check_conservation`` proves both layers — the free
list + unique live blocks partition the id space AND refcounts sum
exactly to table references with every live refcount ≥ 1.

The serving engine's admission gate and load() reports read it.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence

#: Token positions hashed into a prefix key: long enough to tell system
#: prompts apart, short enough that one hash covers every turn of a
#: session sharing the same preamble.
PREFIX_KEY_TOKENS = 32


def prefix_key(tokens: Sequence[int], n: int = PREFIX_KEY_TOKENS) -> str:
    """Stable identity of a prompt's shared head (system prompt, session
    preamble): the cache-affinity key the LB scores dispatch on and the
    engine reports as a resident-prefix hint. Hashes the FIRST ``n``
    token ids — two prompts sharing their head share the key, so a
    routed repeat lands where those KV blocks already live."""
    h = hashlib.sha1(
        ",".join(str(int(t)) for t in tokens[:n]).encode()
    ).hexdigest()
    return f"p:{h[:12]}"


#: Chunk width of the prefix-key CHAIN (a compressed radix tree of
#: prompt heads): prefix identity is hashed at every PREFIX_CHAIN_BLOCK-token
#: boundary up to PREFIX_KEY_TOKENS, so two prompts sharing only part of
#: their head still share the chain keys covering the common blocks.
PREFIX_CHAIN_BLOCK = 8


def prefix_chain(tokens: Sequence[int],
                 block_size: int = PREFIX_CHAIN_BLOCK,
                 max_tokens: int = PREFIX_KEY_TOKENS) -> List[str]:
    """Block-aligned prefix-key chain, shortest head first: key ``i``
    hashes the first ``(i+1) * block_size`` token ids. This is the
    compressed-radix identity of the prompt's head — matching the
    LONGEST shared chain key is exactly a radix-tree longest-prefix
    lookup, without storing raw token ids anywhere off the engine.
    Prompts shorter than one block have no chain (no shared head worth
    routing for). The exact 32-token :func:`prefix_key` remains the
    session-grade identity; the chain generalises it to partial
    overlaps."""
    n_blocks = min(len(tokens), max_tokens) // block_size
    out: List[str] = []
    for i in range(n_blocks):
        h = hashlib.sha1(
            ",".join(str(int(t))
                     for t in tokens[:(i + 1) * block_size]).encode()
        ).hexdigest()
        out.append(f"c:{h[:12]}:{i + 1}")
    return out


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks covering ``tokens`` KV positions (ceil division; a
    zero-token request still pins one block — every admitted sequence
    owns at least its first page). THE one sizing rule: pool sizing
    (dense equivalents) and per-sequence accounting must round the same
    way or capacity math drifts from the ledger."""
    return max(1, -(-int(tokens) // int(block_size)))


class BlockAccountingError(RuntimeError):
    """A free-list invariant was violated (double free, unknown sequence,
    conservation breach). Always a bug in the caller or the allocator —
    never expected under load."""


class BlocksExhausted(RuntimeError):
    """alloc() refused: the free list cannot cover the request. Expected
    under load — the admission layer's signal to keep the request
    queued until a retirement returns blocks."""


class KVBlockAllocator:
    """Fixed-size KV block pool with per-sequence block tables and exact
    alloc/free accounting. Thread-safe: the engine driver thread and the
    HTTP/load-report threads may touch it concurrently."""

    def __init__(self, total_blocks: int, block_size: int):
        if total_blocks <= 0:
            raise ValueError(f"total_blocks must be > 0, got {total_blocks}")
        if block_size <= 0:
            raise ValueError(f"block_size must be > 0, got {block_size}")
        self.total_blocks = int(total_blocks)
        self.block_size = int(block_size)
        # LIFO free list: recently-freed blocks are re-used first (their
        # rows are the ones most likely still warm in HBM/cache).
        self._free: List[int] = list(range(self.total_blocks - 1, -1, -1))
        self._tables: Dict[object, List[int]] = {}
        # Refcount per LIVE physical block id (present iff live). A block
        # referenced by k tables has refcount k; it returns to the free
        # list only when the count reaches zero.
        self._ref: Dict[int, int] = {}
        self._lock = threading.Lock()
        # Cumulative ledger counters (ints, monotone): the conservation
        # invariant is allocated == freed + live at every instant, where
        # allocated/freed count PHYSICAL free-list pops/returns (a shared
        # reference is not an allocation — HBM did not grow).
        self.blocks_allocated_total = 0
        self.blocks_freed_total = 0
        self.high_water_blocks = 0
        # COW ledger: forks taken because a writer hit a block whose
        # refcount was > 1.
        self.cow_copies_total = 0
        # Logical sharing ledger: shared references taken via alloc(...,
        # shared=) — each is one table entry that cost zero free blocks.
        self.shared_refs_total = 0

    # ------------- sizing -------------

    def blocks_for_tokens(self, tokens: int) -> int:
        """This pool's sizing of ``tokens`` positions (see the module
        function)."""
        return blocks_for_tokens(tokens, self.block_size)

    # ------------- queries -------------

    @property
    def blocks_live(self) -> int:
        """UNIQUE physical blocks held by live tables — the HBM-governing
        count. Equal to the sum of table lengths only when nothing is
        shared."""
        with self._lock:
            return len(self._ref)

    @property
    def table_refs(self) -> int:
        """Logical references: sum of table lengths (≥ blocks_live; the
        gap is sharing)."""
        with self._lock:
            return sum(len(t) for t in self._tables.values())

    @property
    def blocks_shared(self) -> int:
        """Physical blocks currently referenced by more than one table —
        the pages COW sharing is saving."""
        with self._lock:
            return sum(1 for c in self._ref.values() if c > 1)

    @property
    def blocks_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def sequences_live(self) -> int:
        with self._lock:
            return len(self._tables)

    def table(self, seq_id) -> Optional[List[int]]:
        with self._lock:
            t = self._tables.get(seq_id)
            return list(t) if t is not None else None

    def refcount(self, block_id: int) -> int:
        """Live refcount of a physical block (0 = free/unknown). The
        engine's COW-prepare pass uses this to find the shared blocks a
        dispatch's write range is about to touch."""
        with self._lock:
            return self._ref.get(int(block_id), 0)

    def can_alloc(self, tokens: int, shared: int = 0) -> bool:
        """Whether a request of ``tokens`` positions is admissible.
        ``shared`` leading blocks (already live, to be referenced via
        ``alloc(..., shared=)``) cost nothing from the free list."""
        with self._lock:
            need = max(0, self.blocks_for_tokens(tokens) - int(shared))
            return need <= len(self._free)

    # ------------- mutation -------------

    def alloc(self, seq_id, tokens: int,
              shared: Optional[Sequence[int]] = None) -> List[int]:
        """Claim the blocks covering ``tokens`` positions for ``seq_id``.

        ``shared`` maps the sequence's LEADING blocks onto already-live
        physical ids (COW prefix sharing): each listed id gets its
        refcount bumped instead of a free-list pop, so only the remainder
        costs physical blocks. Every shared id must currently be live.

        Raises BlocksExhausted when the free list cannot cover the
        non-shared remainder (the request stays queued) and
        BlockAccountingError when the sequence already holds a table or
        a shared id is not live (an admit/retire bookkeeping bug)."""
        n = self.blocks_for_tokens(tokens)
        shared = list(shared or [])
        if len(shared) > n:
            raise BlockAccountingError(
                f"sequence {seq_id!r}: {len(shared)} shared blocks exceed "
                f"the {n}-block table for {tokens} tokens"
            )
        with self._lock:
            if seq_id in self._tables:
                raise BlockAccountingError(
                    f"sequence {seq_id!r} already holds "
                    f"{len(self._tables[seq_id])} blocks — double alloc"
                )
            for b in shared:
                if b not in self._ref:
                    raise BlockAccountingError(
                        f"shared block {b} is not live — cannot take a "
                        "prefix reference on a free or unknown block"
                    )
            fresh_n = n - len(shared)
            if fresh_n > len(self._free):
                raise BlocksExhausted(
                    f"need {fresh_n} blocks for {tokens} tokens "
                    f"({len(shared)} shared), "
                    f"{len(self._free)}/{self.total_blocks} free"
                )
            for b in shared:
                self._ref[b] += 1
            fresh = [self._free.pop() for _ in range(fresh_n)]
            for b in fresh:
                self._ref[b] = 1
            got = [int(b) for b in shared] + fresh
            self._tables[seq_id] = got
            self.blocks_allocated_total += fresh_n
            self.shared_refs_total += len(shared)
            live = self.total_blocks - len(self._free)
            if live > self.high_water_blocks:
                self.high_water_blocks = live
            return list(got)

    def extend(self, seq_id, total_tokens: int) -> List[int]:
        """Grow ``seq_id``'s table to cover ``total_tokens`` positions;
        returns the newly claimed block ids (empty when the table already
        covers it). Raises BlocksExhausted when the pool cannot grow it
        and BlockAccountingError for an unknown sequence."""
        with self._lock:
            t = self._tables.get(seq_id)
            if t is None:
                raise BlockAccountingError(
                    f"extend of unknown sequence {seq_id!r} — "
                    "use-after-free or never-admitted"
                )
            need = self.blocks_for_tokens(total_tokens) - len(t)
            if need <= 0:
                return []
            if need > len(self._free):
                raise BlocksExhausted(
                    f"need {need} more blocks, {len(self._free)} free"
                )
            got = [self._free.pop() for _ in range(need)]
            for b in got:
                self._ref[b] = 1
            t.extend(got)
            self.blocks_allocated_total += need
            live = self.total_blocks - len(self._free)
            if live > self.high_water_blocks:
                self.high_water_blocks = live
            return list(got)

    def write_fork(self, seq_id, block_pos: int) -> Optional[tuple]:
        """Copy-on-write: ensure ``seq_id`` exclusively owns the block at
        table position ``block_pos`` before a KV write lands in it.

        If the block's refcount is 1 the write is already safe and this
        returns None. Otherwise a fresh physical block is claimed, the
        table entry is swapped to it, the original is decref'd, and
        ``(old_id, new_id)`` is returned so the caller can copy the
        page's contents old→new in the physical pool. Raises
        BlocksExhausted when no free block exists to fork into and
        BlockAccountingError for an unknown sequence or bad position."""
        with self._lock:
            t = self._tables.get(seq_id)
            if t is None:
                raise BlockAccountingError(
                    f"write_fork of unknown sequence {seq_id!r} — "
                    "use-after-free or never-admitted"
                )
            if not (0 <= block_pos < len(t)):
                raise BlockAccountingError(
                    f"write_fork position {block_pos} outside "
                    f"{seq_id!r}'s {len(t)}-block table"
                )
            old = t[block_pos]
            if self._ref.get(old, 0) <= 0:
                raise BlockAccountingError(
                    f"block {old} in {seq_id!r}'s table has no live "
                    "refcount — ledger corruption"
                )
            if self._ref[old] == 1:
                return None
            if not self._free:
                raise BlocksExhausted(
                    f"COW fork of block {old} needs a free block, "
                    f"0/{self.total_blocks} free"
                )
            new = self._free.pop()
            self._ref[old] -= 1
            self._ref[new] = 1
            t[block_pos] = new
            self.blocks_allocated_total += 1
            self.cow_copies_total += 1
            live = self.total_blocks - len(self._free)
            if live > self.high_water_blocks:
                self.high_water_blocks = live
            return (old, new)

    def free(self, seq_id) -> int:
        """Drop every reference ``seq_id`` holds; blocks whose refcount
        reaches zero return to the free list. Returns the PHYSICAL count
        freed (≤ table length when blocks were shared — retiring one
        reader of a shared prefix must not free pages its siblings still
        attend over). A second free of the same sequence (or a free of
        one never admitted) raises — each reference is dropped exactly
        once."""
        with self._lock:
            t = self._tables.pop(seq_id, None)
            if t is None:
                raise BlockAccountingError(
                    f"free of unknown sequence {seq_id!r} — double free "
                    "or never-admitted"
                )
            physical = 0
            for b in reversed(t):
                c = self._ref.get(b, 0)
                if c <= 0:
                    raise BlockAccountingError(
                        f"block {b} freed by {seq_id!r} has no live "
                        "refcount — double free of a shared block"
                    )
                if c == 1:
                    del self._ref[b]
                    self._free.append(b)
                    physical += 1
                else:
                    self._ref[b] = c - 1
            self.blocks_freed_total += physical
            return physical

    # ------------- invariants -------------

    def conservation_ok(self) -> bool:
        with self._lock:
            live = len(self._ref)
            return (self.blocks_allocated_total
                    == self.blocks_freed_total + live)

    def check_conservation(self) -> None:
        """Raise BlockAccountingError unless the full ledger invariant
        holds, both layers:

        physical — allocated == freed + unique live (integer-exact),
        free + unique live == total, and the free list + UNIQUE live
        blocks PARTITION the block id space (every id exactly once
        across both);

        logical — every table entry has a live refcount, refcounts sum
        exactly to the number of table references, and every live
        refcount is ≥ 1 (no orphaned count, no zero-ref live block)."""
        with self._lock:
            refs_from_tables: Dict[int, int] = {}
            table_refs = 0
            for t in self._tables.values():
                table_refs += len(t)
                for b in t:
                    refs_from_tables[b] = refs_from_tables.get(b, 0) + 1
            unique_live = len(refs_from_tables)
            if (self.blocks_allocated_total
                    != self.blocks_freed_total + unique_live):
                raise BlockAccountingError(
                    f"conservation broken: allocated "
                    f"{self.blocks_allocated_total} != freed "
                    f"{self.blocks_freed_total} + live {unique_live}"
                )
            if len(self._free) + unique_live != self.total_blocks:
                raise BlockAccountingError(
                    f"pool leak: free {len(self._free)} + live "
                    f"{unique_live} != total {self.total_blocks}"
                )
            seen = set(self._free)
            if len(seen) != len(self._free):
                raise BlockAccountingError("free list holds duplicates")
            for b in refs_from_tables:
                if b in seen:
                    raise BlockAccountingError(
                        f"block {b} is both free and live"
                    )
                seen.add(b)
            if seen != set(range(self.total_blocks)):
                raise BlockAccountingError(
                    "free list + tables do not cover the block id space"
                )
            if refs_from_tables != self._ref:
                for b, c in refs_from_tables.items():
                    rc = self._ref.get(b, 0)
                    if rc != c:
                        raise BlockAccountingError(
                            f"block {b}: refcount {rc} != {c} table "
                            "references"
                        )
                orphans = set(self._ref) - set(refs_from_tables)
                raise BlockAccountingError(
                    f"refcounts held for blocks in no table: "
                    f"{sorted(orphans)}"
                )
            for b, c in self._ref.items():
                if c < 1:
                    raise BlockAccountingError(
                        f"live block {b} has refcount {c} < 1"
                    )
            if sum(self._ref.values()) != table_refs:
                raise BlockAccountingError(
                    f"refcount sum {sum(self._ref.values())} != "
                    f"{table_refs} table references"
                )

    # ------------- reporting -------------

    def snapshot(self) -> dict:
        """Point-in-time ledger view (the engine load() / bench report
        shape)."""
        with self._lock:
            live = len(self._ref)
            table_refs = sum(len(t) for t in self._tables.values())
            shared = sum(1 for c in self._ref.values() if c > 1)
            return {
                "kv_block_size": self.block_size,
                "kv_blocks_total": self.total_blocks,
                "kv_blocks_live": live,
                "kv_blocks_free": len(self._free),
                "kv_blocks_allocated_total": self.blocks_allocated_total,
                "kv_blocks_freed_total": self.blocks_freed_total,
                "kv_blocks_high_water": self.high_water_blocks,
                "kv_blocks_shared": shared,
                "kv_table_refs": table_refs,
                "kv_cow_copies_total": self.cow_copies_total,
                "kv_shared_refs_total": self.shared_refs_total,
                "kv_sequences_live": len(self._tables),
                "kv_conservation_ok": (
                    self.blocks_allocated_total
                    == self.blocks_freed_total + live),
            }

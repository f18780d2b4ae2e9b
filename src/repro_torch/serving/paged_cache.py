"""Paged KV cache: fixed-size blocks, refcounted free-list allocation,
block tables, and cross-request shared-prefix block reuse (twin of
``repro/serving/paged_cache.py``).

The device side is a *physical block pool* per attention layer
(models/transformer.init_paged_cache — torch tensors of shape (repeat,
num_blocks, block_size, Hkv, head_dim) on the engine's device, no batch
axis; an MLA layer's latent pools are (repeat, num_blocks, block_size,
kv_lora_rank) and (..., qk_rope_head_dim)), and a slot-state pool per
mamba2 layer, all written in place by the paged steps.  The host side is a copy of
the reference's bookkeeping: which physical blocks belong to which
request, how many are free, and — with ``share_prefix`` — which blocks
hold which *content*.

Block 0 is the reserved **null block**: it is never allocated, idle batch
slots point every block-table entry at it, and the padded tail of short
tables also maps there, so stray writes land in a scratch page that no
live request ever reads (layers.paged_attention and
mla.mla_paged_attention mask it out).

Prefix sharing: every *full* block a request has written can be registered
in a content index keyed by a hash chain over its ``block_size``-token
chunks (serving/prefix_hash.py), so equal keys imply bitwise-equal KV.  A
later request whose context starts with the same chain is handed the same
physical blocks at admission — reference counts go up, its prefill starts
at the matched boundary, and no KV is recomputed.  When the last request
drops a registered block it retires into an LRU pool of
unreferenced-but-cached blocks, reusable on a future hash hit and evicted
(oldest first) only when ``reserve`` would otherwise report OOM.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serving.prefix_hash import chain_keys

NULL_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Physical blocks needed to hold n_tokens."""
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Refcounted free-list allocator over physical block ids 1..num_blocks-1.

    Allocation is all-or-nothing (returns None instead of a partial grant)
    so a request under cache pressure either fits or triggers preemption.
    Every allocated block carries a reference count (fresh allocations
    start at 1); a block returns to the free list only when its count
    reaches 0.  Double-free and foreign-block frees raise.

    ``observer`` (analysis/sanitizer.CacheSanitizer, None unless a sanitizer
    is attached) is told of every alloc, incref and decref, and of every
    invalid free or incref before the allocator raises.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least the null block + one real block")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> low ids first
        self._ref: dict[int, int] = {}                    # block -> refcount
        self.observer = None

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        if self.observer is not None:
            self.observer.on_alloc(blocks)
        return blocks

    def incref(self, block: int) -> int:
        if block == NULL_BLOCK or block not in self._ref:
            if self.observer is not None:
                self.observer.on_invalid_incref(block)  # raises with sites
            if block == NULL_BLOCK:
                raise ValueError("cannot reference the null block")
            raise ValueError(f"incref on unallocated block {block}")
        self._ref[block] += 1
        if self.observer is not None:
            self.observer.on_incref(block, self._ref[block])
        return self._ref[block]

    def decref(self, block: int) -> int:
        """Drop one reference; at 0 the block returns to the free list.
        Returns the remaining count."""
        if block == NULL_BLOCK or block not in self._ref:
            if self.observer is not None:
                self.observer.on_invalid_free(block)    # raises with sites
            if block == NULL_BLOCK:
                raise ValueError("cannot free the null block")
            raise ValueError(f"double free / foreign block {block}")
        self._ref[block] -= 1
        remaining = self._ref[block]
        if remaining == 0:
            del self._ref[block]
            self._free.append(block)
        if self.observer is not None:
            self.observer.on_decref(block, remaining)
        return remaining

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block."""
        for b in blocks:
            self.decref(b)


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    block_size: int
    num_blocks: int            # physical, including the reserved null block
    max_blocks_per_seq: int    # block-table width (= ceil(max_len / bs))
    slots: int = 0             # slot-state pool rows (0: attn-only arch)
    share_prefix: bool = False  # cross-request full-block prefix reuse


class PagedKVCache:
    """Device block pools + allocator + per-request block tables.

    With ``cfg.slots`` > 0 the device pools also carry slot-indexed state
    pools for O(1)-per-request caches; serving/cache_manager.py layers the
    slot-row bookkeeping on top of this class.

    With ``cfg.share_prefix`` the host side additionally keeps the content
    index (hash chain -> physical block), per-block reference counts beyond
    1, and the LRU pool of unreferenced-but-cached blocks described in the
    module docstring.  The device pools are untouched by sharing: it is
    pure block-table indirection."""

    def __init__(self, arch: ArchConfig, cfg: PagedCacheConfig, *, device,
                 dtype=torch.bfloat16):
        self.arch, self.cfg = arch, cfg
        self.pools = T.init_paged_cache(arch, cfg.num_blocks, cfg.block_size,
                                        device=device, dtype=dtype,
                                        slots=cfg.slots)
        self._init_host_state()

    @classmethod
    def host_only(cls, cfg: PagedCacheConfig) -> "PagedKVCache":
        """The host-side bookkeeping alone: allocator, block tables, prefix
        index, LRU — no device pools and no arch (``pools`` is None).  It is
        the object the engine's control plane mutates, for model checking
        and state snapshots."""
        self = cls.__new__(cls)
        self.arch, self.cfg, self.pools = None, cfg, None
        self._init_host_state()
        return self

    def _init_host_state(self) -> None:
        cfg = self.cfg
        self.allocator = BlockAllocator(cfg.num_blocks)
        self.tables: dict[int, list[int]] = {}   # request id -> physical blocks
        # chain key -> block holding that full chunk; key = (prev_key, chunk)
        self._hash_to_block: dict[tuple, int] = {}
        self._block_to_hash: dict[int, tuple] = {}
        # unreferenced-but-cached blocks, oldest first; each holds exactly
        # one reference (the index's) until eviction or a new hash hit
        self._lru: OrderedDict[int, None] = OrderedDict()
        # rid -> (full blocks committed, chain key of the last one)
        self._committed: dict[int, tuple[int, Optional[tuple]]] = {}
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.prefix_evictions = 0

    # -- prefix index --------------------------------------------------------
    def match_prefix(self, tokens) -> list[int]:
        """Longest chain of cached full blocks covering a prefix of
        ``tokens`` — capped at len(tokens)-1 so at least one token is left
        to prefill.  No side effects."""
        if not self.cfg.share_prefix:
            return []
        bs = self.cfg.block_size
        limit = max(len(tokens) - 1, 0) // bs
        blocks = []
        for key in chain_keys(tokens, bs, 0, limit):
            b = self._hash_to_block.get(key)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def assign_prefix(self, rid: int, tokens) -> int:
        """Hand request ``rid`` the cached blocks matching its context
        prefix; returns the number of matched tokens (prefill starts
        there).  Must run before the first ``reserve`` for rid."""
        if not self.cfg.share_prefix:
            return 0
        if rid in self.tables:
            raise ValueError(f"request {rid} already holds blocks — "
                             f"assign_prefix must precede reserve")
        blocks = self.match_prefix(tokens)
        self.prefix_lookup_tokens += len(tokens)
        if not blocks:
            return 0
        for b in blocks:
            self.allocator.incref(b)
            self._lru.pop(b, None)
        self.tables[rid] = list(blocks)
        self._committed[rid] = (len(blocks), self._block_to_hash[blocks[-1]])
        n = len(blocks) * self.cfg.block_size
        self.prefix_hit_tokens += n
        return n

    def commit_prefix(self, rid: int, tokens, n_resident: int) -> None:
        """Register rid's freshly written full blocks in the content index
        (first writer wins on duplicate content).  The index holds one
        reference per registered block."""
        if not self.cfg.share_prefix:
            return
        table = self.tables.get(rid)
        if table is None:
            return
        n_full = min(n_resident // self.cfg.block_size, len(table))
        start, prev = self._committed.get(rid, (0, None))
        if n_full <= start:
            return
        keys = chain_keys(tokens, self.cfg.block_size, start, n_full, prev)
        for i, key in zip(range(start, n_full), keys):
            b = table[i]
            if b in self._block_to_hash or key in self._hash_to_block:
                continue                       # already indexed / duplicate
            self._hash_to_block[key] = b
            self._block_to_hash[b] = key
            self.allocator.incref(b)
        self._committed[rid] = (n_full, keys[-1])

    def _evict_for(self, need: int) -> None:
        """Evict unreferenced cached blocks (oldest first) until ``need``
        blocks are free or the LRU is empty."""
        while self.allocator.num_free < need and self._lru:
            b, _ = self._lru.popitem(last=False)
            key = self._block_to_hash.pop(b)
            del self._hash_to_block[key]
            self.allocator.decref(b)           # index's ref: 1 -> 0 -> free
            self.prefix_evictions += 1

    @property
    def num_cached(self) -> int:
        """Unreferenced-but-cached blocks reclaimable by eviction."""
        return len(self._lru)

    def prefix_stats(self) -> dict:
        hit = self.prefix_hit_tokens
        lookup = self.prefix_lookup_tokens
        return {"hit_tokens": hit, "lookup_tokens": lookup,
                "hit_rate": hit / lookup if lookup else 0.0,
                "cached_blocks": self.num_cached,
                "indexed_blocks": len(self._block_to_hash),
                "evictions": self.prefix_evictions}

    # -- allocation ----------------------------------------------------------
    def reserve(self, rid: int, n_tokens: int) -> bool:
        """Grow request rid's table to cover n_tokens total; False on OOM
        (state unchanged).  Cached LRU blocks are evicted before OOM is
        reported."""
        have = len(self.tables.get(rid, ()))
        need = blocks_for(n_tokens, self.cfg.block_size) - have
        if need <= 0:
            return True
        if need > self.allocator.num_free:
            self._evict_for(need)
        got = self.allocator.alloc(need)
        if got is None:
            return False
        self.tables.setdefault(rid, []).extend(got)
        return True

    def release(self, rid: int) -> None:
        """Drop rid's reference on every block in its table.  A block whose
        only remaining holder is the content index retires into the LRU;
        retirement is tail-first so eviction sacrifices a chain's tail
        before its matchable head."""
        blocks = self.tables.pop(rid, None)
        self._committed.pop(rid, None)
        if not blocks:
            return
        for b in reversed(blocks):
            remaining = self.allocator.decref(b)
            if remaining == 1 and b in self._block_to_hash:
                self._lru[b] = None

    def can_fit(self, n_tokens: int) -> bool:
        return blocks_for(n_tokens, self.cfg.block_size) \
            <= self.allocator.num_free + len(self._lru)

    def can_fit_request(self, tokens) -> bool:
        """Admission check for a full context: new blocks needed after
        prefix matching vs free + evictable (matched blocks are neither)."""
        matched = self.match_prefix(tokens)
        need = blocks_for(len(tokens), self.cfg.block_size) - len(matched)
        evictable = len(self._lru) - sum(1 for b in matched if b in self._lru)
        return need <= self.allocator.num_free + evictable

    @property
    def pool_bytes(self) -> int:
        """Device memory resident in the cache pools (every leaf: block
        pools and slot-state rows alike, wdec's nested ones included)."""
        return sum(t.numel() * t.element_size()
                   for t in tree.leaves(self.pools))

    def stats(self) -> dict:
        """JSON-able cache-layer stats: allocator occupancy, geometry, and
        the prefix-index counters."""
        return {"num_blocks": self.cfg.num_blocks,
                "block_size": self.cfg.block_size,
                "num_free": self.allocator.num_free,
                "num_used": self.allocator.num_used,
                "utilization": self.utilization,
                "pool_bytes": self.pool_bytes,
                "prefix": self.prefix_stats() if self.cfg.share_prefix
                else None}

    @property
    def utilization(self) -> float:
        """Live cache pressure: blocks held by running requests / usable
        (LRU-retired prefix blocks are reclaimable and excluded)."""
        usable = self.cfg.num_blocks - 1
        return (self.allocator.num_used - len(self._lru)) / max(usable, 1)

    # -- host state snapshot ------------------------------------------------
    @staticmethod
    def _flat_key(key: Optional[tuple]) -> tuple:
        """Chain key -> the flat token prefix it commits to."""
        out: list[int] = []
        while key is not None:
            key, chunk = key
            out[:0] = chunk
        return tuple(out)

    def _nest_key(self, flat) -> Optional[tuple]:
        """Inverse of ``_flat_key``: fold a flat token prefix back into the
        (prev, chunk) chain form, one chunk per block_size tokens."""
        bs = self.cfg.block_size
        prev: Optional[tuple] = None
        for i in range(0, len(flat), bs):
            prev = (prev, tuple(int(t) for t in flat[i:i + bs]))
        return prev

    def host_state_dict(self) -> dict:
        """JSON-able snapshot of every host-side structure: the free list
        (its order decides which block is reused next), refcounts, block
        tables, the prefix index (as flat token prefixes), LRU order,
        commit cursors and the prefix counters.  The device pools are not
        included: their contents are recomputable from the tokens."""
        alloc = self.allocator
        return {
            "free_list": list(alloc._free),
            "refcounts": [[b, alloc._ref[b]] for b in sorted(alloc._ref)],
            "tables": [[rid, list(bs)]
                       for rid, bs in sorted(self.tables.items())],
            "prefix_index": [[list(self._flat_key(k)), b]
                             for k, b in sorted(self._hash_to_block.items(),
                                                key=lambda kv: kv[1])],
            "lru": list(self._lru),
            "committed": [[rid, n, None if key is None
                           else list(self._flat_key(key))]
                          for rid, (n, key) in sorted(self._committed.items())],
            "counters": {"prefix_hit_tokens": self.prefix_hit_tokens,
                         "prefix_lookup_tokens": self.prefix_lookup_tokens,
                         "prefix_evictions": self.prefix_evictions},
        }

    def load_host_state_dict(self, state: dict) -> None:
        """Restore from ``host_state_dict()`` output (same cfg geometry),
        coercing ints so a JSON or npz round trip restores it exactly."""
        alloc = self.allocator
        alloc._free = [int(b) for b in state["free_list"]]
        alloc._ref = {int(b): int(rc) for b, rc in state["refcounts"]}
        self.tables = {int(rid): [int(b) for b in bs]
                       for rid, bs in state["tables"]}
        self._hash_to_block = {}
        self._block_to_hash = {}
        for flat, b in state["prefix_index"]:
            key = self._nest_key(flat)
            self._hash_to_block[key] = int(b)
            self._block_to_hash[int(b)] = key
        self._lru = OrderedDict((int(b), None) for b in state["lru"])
        self._committed = {
            int(rid): (int(n), None if flat is None else self._nest_key(flat))
            for rid, n, flat in state["committed"]}
        c = state["counters"]
        self.prefix_hit_tokens = int(c["prefix_hit_tokens"])
        self.prefix_lookup_tokens = int(c["prefix_lookup_tokens"])
        self.prefix_evictions = int(c["prefix_evictions"])

    # -- device-side views ---------------------------------------------------
    def table_row(self, rid: Optional[int]) -> np.ndarray:
        """(max_blocks_per_seq,) int32, padded with the null block.  rid=None
        (idle slot) is an all-null row."""
        row = np.full((self.cfg.max_blocks_per_seq,), NULL_BLOCK, np.int32)
        if rid is not None:
            blocks = self.tables[rid]
            row[: len(blocks)] = blocks
        return row

    def table_array(self, rids: list[Optional[int]]) -> np.ndarray:
        """(B, max_blocks_per_seq) int32 block tables for a slot vector."""
        return np.stack([self.table_row(r) for r in rids])

"""Prefix-affinity routing index for the cluster router (twin of
``repro/serving/cluster/affinity.py``).

The point: the engine's cross-request prefix cache serves shared-system-
prompt traffic from cached blocks *within one engine*.  Naive round-robin
across replicas shatters that — each replica sees 1/N of the requests
sharing a prefix and re-prefills the prefix independently.  This index
routes a prompt to the replica that already committed the blocks its
prefix hashes to, keeping the aggregate hit rate at the single-process
value.

It is a *router-local shadow* of the workers' paged-cache content
indexes, keyed by literally the same chain keys
(serving/prefix_hash.chain_keys — see that module for why sharing the
function matters).  The shadow is optimistic: it records which replica
a prompt's full blocks were *sent to*, not whether the worker's cache
still holds them (eviction is invisible up here).  A stale entry costs
one cache miss on a well-chosen replica — strictly no worse than the
least-loaded fallback — so optimism is safe.

``route`` returns the replica holding the *longest* matching prefix
among live replicas.  No match ⇒ the caller falls back to least-loaded.
The map is LRU-capped (OrderedDict, move-to-end on hit) so a long-lived
router cannot grow without bound; capacity evicts the coldest prefix
keys first, mirroring the workers' own LRU block eviction.

No torch in this module: routing is pure host-side bookkeeping (the
router process never builds a mesh or touches a device).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

from repro_torch.serving.prefix_hash import chain_keys


class PrefixAffinity:
    def __init__(self, block_size: int, *, max_keys: int = 65536):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1 (got {block_size})")
        if max_keys < 1:
            raise ValueError(f"max_keys must be >= 1 (got {max_keys})")
        self.block_size = block_size
        self.max_keys = max_keys
        self._owner: OrderedDict = OrderedDict()   # chain key -> replica id
        self.stats = {"routed_affinity": 0, "routed_fallback": 0,
                      "keys_evicted": 0}

    def __len__(self) -> int:
        return len(self._owner)

    def route(self, tokens: Sequence[int], live: Sequence[int]) \
            -> tuple[Optional[int], int]:
        """-> (replica or None, matched_blocks).  The replica owning the
        longest full-block prefix of ``tokens`` among ``live`` replicas;
        ``None`` when no prefix key maps to a live replica (caller falls
        back to least-loaded).  Matching walks the chain from the end —
        same longest-prefix semantics as ``PagedKVCache.match_prefix`` —
        and skips keys owned by dead replicas rather than stopping, since
        a shorter prefix on a live replica still beats a cold start."""
        live_set = set(live)
        best: tuple[Optional[int], int] = (None, 0)
        for n, key in enumerate(chain_keys(tokens, self.block_size), 1):
            owner = self._owner.get(key)
            if owner in live_set:
                best = (owner, n)
                self._owner.move_to_end(key)       # LRU touch
        if best[0] is not None:
            self.stats["routed_affinity"] += 1
        else:
            self.stats["routed_fallback"] += 1
        return best

    def commit(self, tokens: Sequence[int], replica: int) -> int:
        """Record that ``tokens``' full-block prefix keys now live on
        ``replica`` (called when a request is routed there — by the time
        a later request matches, the worker has prefilled and committed
        the blocks).  Later commits overwrite earlier owners: the newest
        copy is the one most likely still resident.  Returns the number
        of keys recorded."""
        keys = chain_keys(tokens, self.block_size)
        for key in keys:
            self._owner[key] = replica
            self._owner.move_to_end(key)
        while len(self._owner) > self.max_keys:
            self._owner.popitem(last=False)
            self.stats["keys_evicted"] += 1
        return len(keys)

    def drop_replica(self, replica: int) -> int:
        """Forget every key owned by a dead replica; returns how many.
        (``route`` already skips dead owners — this reclaims the space
        and lets colder live entries survive the LRU cap.)"""
        dead = [k for k, r in self._owner.items() if r == replica]
        for k in dead:
            del self._owner[k]
        return len(dead)

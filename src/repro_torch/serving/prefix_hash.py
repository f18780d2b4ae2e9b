"""The prefix hash chain the paged cache keys its content index with
(copy of ``repro/serving/prefix_hash.py``, whose cluster router uses the
same keys for prefix-affinity routing).

A *full* block's key commits to the entire token prefix up to and
including that block, so equal keys imply bitwise-equal KV.  Stdlib only.

A chain key is the nested tuple ``(prev_key, chunk)`` where ``chunk`` is
one ``block_size``-token tuple and ``prev_key`` is the previous block's
key (``None`` at the chain head).  The nesting is an incremental-hashing
optimization: extending a chain by one block hashes only the new chunk,
never the whole prefix.
"""
from __future__ import annotations

from typing import Optional

ChainKey = tuple  # (prev: Optional[ChainKey], chunk: tuple[int, ...])


def chain_keys(tokens, block_size: int, start: int = 0,
               n_blocks: Optional[int] = None,
               prev: Optional[ChainKey] = None) -> list[ChainKey]:
    """Chain keys for the full blocks ``[start, n_blocks)`` of ``tokens``,
    extending ``prev`` (the key of block ``start - 1``; ``None`` at the
    chain head).  ``n_blocks`` defaults to every full block of ``tokens``.
    """
    if n_blocks is None:
        n_blocks = len(tokens) // block_size
    keys = []
    for i in range(start, n_blocks):
        chunk = tuple(int(t) for t in tokens[i * block_size:
                                             (i + 1) * block_size])
        prev = (prev, chunk)
        keys.append(prev)
    return keys

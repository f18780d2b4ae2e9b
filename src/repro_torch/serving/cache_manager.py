"""Unified serving cache manager: paged KV block pools + slot-state pools
(twin of ``repro/serving/cache_manager.py``).

The continuous-batching engine juggles two classes of per-request state,
and this module is the single host-side owner of both:

  * **length-indexed** — attention KV (``attn``, ``moe_attn``, and
    zamba2's ``shared_attn``, whose pool is stacked per application of the
    shared weights) and MLA's latent rows (``mla``, ``mla_dense``: c_kv
    and k_rope, no KV heads) grow one entry per token.  They live in
    fixed-size physical blocks (paged_cache.py: free-list allocator +
    per-request block tables over the pools from
    models/transformer.init_paged_cache).  Block 0 is the reserved null
    block for idle slots / padded table tails / overrun writes.

  * **slot-indexed** — mamba2 ``conv_x/conv_b/conv_c/ssm`` state,
    llama-vision's cross-attention K/V and whisper's per-request encoder
    K/V (the ``wdec`` cross pool) are O(1) per request regardless of
    generated length.  They live in pools with
    one row per engine slot plus a trailing reserved **null slot** row (the
    slot-state analogue of the null block): inactive batch rows in a
    fixed-shape decode step gather and scatter against the null row, so
    their garbage never touches a live request's state.  Rows are reset
    on admission (runtime/steps.make_slot_admit_step — mamba2 zeroed,
    cross K/V computed once from the request's frontend), the SSM state is
    carried as ``h0`` across prefill chunks, and recompute-style
    preemption needs no extra handling: re-admission resets the row (a
    resumed request's cross K/V come from its frontend again) and the
    re-prefill replays prompt + generated tokens through it.

Both classes share one cache structure (a list of per-segment dicts), so
the paged steps thread a single cache, updated in place.

Prefix sharing (paged_cache.py ``share_prefix``) applies to the
length-indexed class ONLY: a paged attention block's KV at position i is a
pure function of the token prefix, so equal hash chains imply equal
content.  mamba2's recurrent state is accumulated *by running prefill*
over every prompt token, so skipping matched tokens would leave it wrong,
and cross-attn / wdec K/V are per-request admission outputs.
Constructing a UnifiedCacheManager with ``share_prefix`` for an arch
carrying any slot-state kind therefore raises up front rather than serving
corrupt state.  Which kinds the port can run at all is
``models/blocks.PORTED_KINDS``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.serving.paged_cache import PagedCacheConfig, PagedKVCache

# length-indexed caches, block-paged through per-request tables.  zamba2's
# weight-shared block pages one pool per application (the repeat-stacked
# leading axis), MLA pages its latent (c_kv, k_rope) rows.
PAGEABLE_KINDS = {"attn", "moe_attn", "shared_attn", "mla", "mla_dense",
                  "wdec"}
# O(1)-per-request state, slot-indexed: mamba2 recurrent state, cross-attn
# K/V, and wdec's per-request encoder K/V (wdec carries BOTH classes: paged
# self-attn KV plus the slot-state cross pool filled once at admission).
SLOT_STATE_KINDS = {"mamba2", "cross_attn", "wdec"}
SERVABLE_KINDS = PAGEABLE_KINDS | SLOT_STATE_KINDS


def check_servable(arch: ArchConfig) -> None:
    """Raise when the engine cannot serve ``arch``: ``NotImplementedError``
    for a block kind the port does not know (``models/blocks.check_arch``),
    and, as the reference's, ``ValueError`` for a known kind with no paged
    or slot-state serving cache (``enc_attn`` in a decoder pattern) and for
    an encoder arch without ``wdec`` blocks to receive its K/V."""
    B.check_arch(arch)
    kinds = {k for seg in arch.pattern for k in seg.blocks}
    unsupported = kinds - SERVABLE_KINDS
    if unsupported:
        raise ValueError(
            f"continuous engine cannot serve {arch.name}: block kinds "
            f"{sorted(unsupported)} have no paged/slot-state serving cache "
            f"(see serving/cache_manager.py)")
    if arch.encoder is not None and "wdec" not in kinds:
        raise ValueError(
            f"continuous engine cannot serve {arch.name}: arch.encoder "
            f"requires wdec decoder blocks to receive the encoder K/V at "
            f"admission")


class UnifiedCacheManager(PagedKVCache):
    """PagedKVCache plus slot-state row bookkeeping.

    The block side (reserve / release / can_fit / table_array) is inherited
    unchanged.  The slot side is deliberately thin: engine slot i *is* pool
    row i, so admission/finish need no allocation — only the null-row
    mapping for inactive batch rows, provided by :meth:`slot_ids_array`.
    """

    def __init__(self, arch: ArchConfig, cfg: PagedCacheConfig, *, device,
                 dtype=torch.bfloat16, mesh=None, specs=None):
        check_servable(arch)
        kinds = {k for seg in arch.pattern for k in seg.blocks}
        self.slot_state_kinds = sorted(kinds & SLOT_STATE_KINDS)
        if self.slot_state_kinds and cfg.slots <= 0:
            raise ValueError(f"{arch.name} carries slot-state caches "
                             f"({self.slot_state_kinds}) — cfg.slots must "
                             f"be the engine slot count")
        if cfg.share_prefix and self.slot_state_kinds:
            raise ValueError(
                f"prefix sharing cannot serve {arch.name}: slot-state rows "
                f"({self.slot_state_kinds}) are per-request — mamba2 "
                f"recurrent state is built by prefilling every prompt token "
                f"(a matched prefix would be skipped, leaving it wrong) and "
                f"cross-attn/wdec K/V are admission-time frontend outputs "
                f"with no content key.  Only purely paged archs "
                f"(attention / MLA block kinds) may share; serve this arch "
                f"with share_prefix=False")
        super().__init__(arch, cfg, device=device, dtype=dtype, mesh=mesh,
                         specs=specs)

    @property
    def has_slot_state(self) -> bool:
        return bool(self.slot_state_kinds)

    @property
    def null_slot(self) -> int:
        """Reserved scratch row index (= cfg.slots): inactive batch rows
        gather/scatter here, mirroring the null block."""
        return self.cfg.slots

    def slot_ids_array(self, rows: list[Optional[int]]) -> np.ndarray:
        """(B,) int32 pool-row vector: the given slot row (``_Slot.idx``)
        for active batch rows, the null slot row for None (inactive)."""
        return np.asarray([self.null_slot if r is None else r
                           for r in rows], np.int32)

    def stats(self) -> dict:
        """Paged-layer stats plus the slot-state dimension of the unified
        cache (which state classes this arch carries, and how many rows)."""
        out = super().stats()
        out["slot_state_kinds"] = list(self.slot_state_kinds)
        out["slot_rows"] = self.cfg.slots if self.has_slot_state else 0
        return out

"""Paged serving steps for the continuous-batching engine (twin of the paged
half of ``repro/runtime/steps.py``).

The steps take the shared serving cache (``transformer.init_paged_cache``)
plus per-sequence position vectors (B,), block tables (B, max_blocks) and
slot ids (B,) (slot-state pool rows; None for archs without slot state).
The reference jits them and donates the cache (``STEP_DONATION``); the
port runs eagerly and updates the pools IN PLACE — the cache returned is
the same object that was passed in.

With ``sampler`` (``serving.sampling.make_sampler``) the steps fuse the
greedy sampler: they take per-row (temperature, top_k, top_p, seeds) host
arrays, or None each when every row is greedy (as the engine passes them),
and return (token (B,), logprob (B,), cache) instead of logits.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def make_paged_prefill_step(arch: ArchConfig, *, impl: str = "xla",
                            sampler=None):
    """-> prefill(params, cache, tokens (B,C), positions, block_tables,
    new_lens, slot_ids) -> (last_valid_logits (B,V), cache).  Called once
    per prompt *chunk*.  ``new_lens`` (B,) is the real token count per row;
    the chunk may be padded to a fixed C, and the returned logits are taken
    at row new_lens-1 (the last real token).  ``slot_ids`` (B,) maps rows
    to slot-state pool rows (the mamba2 state is carried as h0 across
    chunks).

    With ``sampler`` the signature gains (temperature, top_k, top_p, seeds)
    and returns (token (B,), logprob (B,), cache): the token after the
    chunk, at absolute position ``positions + new_lens`` (only consumed on
    the final chunk of a prompt)."""
    def _last_logits(params, cache, tokens, positions, block_tables,
                     new_lens, slot_ids):
        out = T.lm_apply(params, arch, tokens, cache=cache,
                         positions=positions, block_tables=block_tables,
                         new_lens=new_lens, slot_ids=slot_ids, impl=impl)
        idx = (new_lens - 1).long()[:, None, None].expand(
            -1, 1, out.logits.shape[-1])
        return torch.gather(out.logits, 1, idx)[:, 0], out.cache

    if sampler is None:
        return _last_logits

    def paged_prefill_step(params, cache, tokens, positions, block_tables,
                           new_lens, slot_ids, temperature, top_k, top_p,
                           seeds):
        last, cache = _last_logits(params, cache, tokens, positions,
                                   block_tables, new_lens, slot_ids)
        tok, logp = sampler(last, temperature, top_k, top_p, seeds,
                            positions + new_lens)
        return tok, logp, cache
    return paged_prefill_step


def make_paged_decode_step(arch: ArchConfig, *, impl: str = "xla",
                           sampler=None):
    """-> decode(params, cache, tokens (B,1), positions, block_tables,
    slot_ids) -> (logits (B,V), cache).  Every batch row advances at its
    *own* position — rows of idle/prefilling slots point their block
    tables at the null block and their slot ids at the null slot row, and
    are discarded by the caller.

    With ``sampler`` the signature gains (temperature, top_k, top_p, seeds)
    and returns (token (B,), logprob (B,), cache): the next token at
    absolute position ``positions + 1``."""
    def _logits(params, cache, tokens, positions, block_tables, slot_ids):
        out = T.lm_apply(params, arch, tokens, cache=cache,
                         positions=positions, block_tables=block_tables,
                         slot_ids=slot_ids, impl=impl)
        return out.logits[:, -1], out.cache

    if sampler is None:
        return _logits

    def paged_decode_step(params, cache, tokens, positions, block_tables,
                          slot_ids, temperature, top_k, top_p, seeds):
        logits, cache = _logits(params, cache, tokens, positions,
                                block_tables, slot_ids)
        tok, logp = sampler(logits, temperature, top_k, top_p, seeds,
                            positions + 1)
        return tok, logp, cache
    return paged_decode_step


def make_slot_admit_step(arch: ArchConfig):
    """-> admit(params, cache, slot_id) -> cache.  Resets one engine slot's
    rows in every slot-state pool on admission (mamba2 state zeroed, in
    place — see transformer.admit_slot).  No-op for paged block pools."""
    def slot_admit_step(params, cache, slot_id):
        return T.admit_slot(params, arch, cache, int(slot_id))
    return slot_admit_step

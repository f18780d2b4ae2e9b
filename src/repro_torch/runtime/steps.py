"""Step factories (twin of ``repro/runtime/steps.py``): the train step
(loss, grads, microbatch accumulation, clipping, optimizer) and the paged
serving steps for the continuous-batching engine.

The train step takes ``(params, opt_state, batch)`` and returns them
updated, as the reference's does; the reference donates ``(params,
opt_state)`` to it (``STEP_DONATION["train"]``), and the port updates both
IN PLACE — the params and moments returned are the tensors passed in.

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

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O


def make_loss_fn(arch: ArchConfig, *, impl: str = "xla", remat: str = "none",
                 mtp_weight: float = 0.3):
    """-> loss_fn(params, tokens (B,S), labels (B,S), frontend=None) ->
    (total, ce), both 0-d fp32, as the reference's (``frontend``: the
    batch's modality embeddings, which ``lm_apply`` takes; the encoder
    runs inside the forward, under autograd and ``remat``): ce is the mean
    next-token cross-entropy
    (``transformer.lm_loss``), plus for an MTP arch ``mtp_weight`` times
    the MTP head's cross-entropy against the labels shifted left by one
    (the wrapped last column masked out); total adds the MoE layers' aux
    loss to it, and is what the train step differentiates."""
    def loss_fn(params, tokens, labels, frontend=None):
        out = T.lm_apply(params, arch, tokens, frontend=frontend, impl=impl,
                         remat=remat, return_hidden=arch.mtp)
        loss = T.lm_loss(out.logits, labels, arch.vocab)
        if arch.mtp:
            # depth-1 MTP: hidden_t + emb(token_{t+1}) predicts token_{t+2}
            mtp_lg = T.mtp_logits(params, arch, out.hidden, tokens)
            tgt = torch.roll(labels, -1, dims=1)
            mask = torch.ones(tgt.shape, dtype=torch.float32,
                              device=tgt.device)
            mask[:, -1] = 0.0
            loss = loss + mtp_weight * T.lm_loss(mtp_lg, tgt, arch.vocab,
                                                 mask)
        return loss + out.aux, loss
    return loss_fn


def loss_and_grads(loss_fn, params, tokens, labels, frontend=None):
    """-> (total, ce, grads): the loss and its gradient with respect to
    every leaf of ``params`` (a list in ``tree.leaves`` order, each in its
    leaf's dtype).  The params are taken as detached leaves that require
    grad, so the caller's tensors need not."""
    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    total, ce = loss_fn(tree.unflatten(params, live), tokens, labels,
                        frontend)
    grads = torch.autograd.grad(total, live)
    return total.detach(), ce.detach(), list(grads)


def make_train_step(arch: ArchConfig, optimizer, *, microbatches: int = 1,
                    impl: str = "xla", remat: str = "none",
                    clip_norm: float = 1.0, mtp_weight: float = 0.3):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch = {"tokens": (B,S), "labels": (B,S)[, "frontend": (B,T,D)]},
    numpy arrays or tensors; they are moved to the params' device (the
    frontend: the arch's patch or frame embeddings, see ``lm_apply``).
    With ``microbatches`` > 1 the batch is cut into that many slices along
    B, and each slice's grads are
    added in fp32 as g / microbatches (one slice's activations live at a
    time).  Then: clip to global norm ``clip_norm``, the optimizer's
    update, and p = (p.float() + u).to(p.dtype), leaf by leaf, in place.
    metrics: ``loss``, ``ce`` and ``grad_norm`` (0-d fp32 tensors, the
    norm before clipping) and ``step`` (int, after the update).
    ``impl="pallas"`` runs the flash kernel, forward and backward, on CUDA
    (its plain version on the CPU); ``act_sharding`` and
    ``grad_shardings`` are not ported (no mesh yet)."""
    _, opt_update = optimizer
    loss_fn = make_loss_fn(arch, impl=impl, remat=remat,
                           mtp_weight=mtp_weight)

    def train_step(params, opt_state, batch):
        dev = tree.leaves(params)[0].device
        tokens, labels = (torch.as_tensor(batch[k]).to(dev)
                          for k in ("tokens", "labels"))
        frontend = batch.get("frontend")
        if frontend is not None:
            frontend = torch.as_tensor(frontend).to(dev)
        if tokens.shape[0] % microbatches:
            raise ValueError(f"batch of {tokens.shape[0]} rows does not "
                             f"split into {microbatches} microbatches")
        if microbatches == 1:
            total, ce, grads = loss_and_grads(loss_fn, params, tokens,
                                              labels, frontend)
            for i, g in enumerate(grads):     # each leaf's own dtype freed
                grads[i] = g.float()          # as its fp32 copy is made
        else:
            total = ce = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in tree.leaves(params)]
            fronts = (frontend.chunk(microbatches) if frontend is not None
                      else [None] * microbatches)
            for tok, lab, fe in zip(tokens.chunk(microbatches),
                                    labels.chunk(microbatches), fronts):
                t, c, g = loss_and_grads(loss_fn, params, tok, lab, fe)
                for acc, x in zip(grads, g):
                    acc.add_(x.float() / microbatches)
                del g
                total = total + t / microbatches
                ce = ce + c / microbatches
        grads, gnorm = O.clip_by_global_norm(grads, clip_norm)
        # the step owns its fp32 grads: each leaf's update overwrites it
        updates, opt_state = opt_update(tree.unflatten(params, grads),
                                        opt_state, params)
        del grads
        params = O.apply_updates(params, updates)
        metrics = {"loss": total, "ce": ce, "grad_norm": gnorm,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step


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
    """-> admit(params, cache, slot_id[, frontend]) -> cache.  Resets one
    engine slot's rows in every slot-state pool on admission, in place:
    mamba2 state zeroed; cross-attn K/V zeroed or computed once from the
    request's ``frontend`` patch embeddings (1, T, d_model); wdec encoder
    K/V zeroed or computed by running the encoder ONCE over the request's
    frame embeddings (see transformer.admit_slot).  No-op for paged block
    pools."""
    def slot_admit_step(params, cache, slot_id, frontend=None):
        return T.admit_slot(params, arch, cache, int(slot_id),
                            frontend=frontend)
    return slot_admit_step

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
sampler: they take per-row (temperature, top_k, top_p, seeds) host arrays
(the engine's ``_sampling_rows``), or None each when every row is greedy,
hand it the absolute position of the token each row produces, and return
(token (B,), logprob (B,), cache) instead of logits.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O

# The reference's buffer-donation table: which positional arguments of
# each step kind it donates to jit.  Here they are the arguments a step
# updates IN PLACE and returns: (params, opt_state) for train, the cache
# for every serving step; params are read-only weights outside training.
# ``analysis/tracecheck.py``'s donation analyzer holds the steps to it.
STEP_DONATION: dict[str, tuple[int, ...]] = {
    "train": (0, 1),
    "prefill": (1,),
    "decode": (1,),
    "paged_prefill": (1,),
    "paged_decode": (1,),
    "slot_admit": (1,),
}


def make_loss_fn(arch: ArchConfig, *, impl: str = "xla", remat: str = "none",
                 mtp_weight: float = 0.3, block_fns=None):
    """-> loss_fn(params, tokens (B,S), labels (B,S), frontend=None) ->
    (total, ce), both 0-d fp32, as the reference's (``frontend``: the
    batch's modality embeddings, which ``lm_apply`` takes; the encoder
    runs inside the forward, under autograd and ``remat``): ce is the mean
    next-token cross-entropy
    (``transformer.lm_loss``), plus for an MTP arch ``mtp_weight`` times
    the MTP head's cross-entropy against the labels shifted left by one
    (the wrapped last column masked out); total adds the MoE layers' aux
    loss to it, and is what the train step differentiates.
    ``block_fns``: ``lm_apply``'s (the sharded step's TP blocks), and
    under ``"mtp"`` the function ``mtp_logits`` takes for its head."""
    def loss_fn(params, tokens, labels, frontend=None):
        out = T.lm_apply(params, arch, tokens, frontend=frontend, impl=impl,
                         remat=remat, return_hidden=arch.mtp,
                         block_fns=block_fns)
        loss = T.lm_loss(out.logits, labels, arch.vocab)
        if arch.mtp:
            # depth-1 MTP: hidden_t + emb(token_{t+1}) predicts token_{t+2}
            mtp_lg = T.mtp_logits(params, arch, out.hidden, tokens,
                                  (block_fns or {}).get("mtp"))
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
                    act_sharding=None, grad_shardings=None,
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
    (its plain version on the CPU).

    With ``act_sharding`` (a ``core.sharding.NamedSharding`` whose spec's
    dim 0 lays the batch over the mesh) and ``grad_shardings`` (the
    params' tree of ``NamedSharding``: the layout the params, moments and
    gradients keep), the step is the sharded one (``runtime/sharded.py``):
    params and moments are DTensors on that mesh; each rank takes its rows
    of each microbatch (the microbatch is the reference's: rows i * B / mb
    to (i + 1) * B / mb of the global batch, then its slice), gathers the
    weights on use, runs every block kind and the MTP head
    tensor-parallel (the MoE experts expert-parallel) where the plan
    shards them over `model`, and reduces each gradient to its
    parameter's placement in the backward; the global norm sums squares
    over shards with one all-reduce; AdamW updates the local shards
    (int8 moments: on the gathered leaves, each rank keeping its shards).
    The MoE aux loss is the global microbatch's (``moe.batch_split``).
    The loss and ce are the means over the ranks (each rank's rows are an
    equal share of the batch)."""
    if (act_sharding is None) != (grad_shardings is None):
        raise ValueError("act_sharding and grad_shardings go together")
    if act_sharding is not None:
        return _make_sharded_train_step(
            arch, optimizer, microbatches=microbatches, impl=impl,
            remat=remat, act_sharding=act_sharding,
            grad_shardings=grad_shardings, clip_norm=clip_norm,
            mtp_weight=mtp_weight)
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


def _make_sharded_train_step(arch, optimizer, *, microbatches, impl, remat,
                             act_sharding, grad_shardings, clip_norm,
                             mtp_weight):
    import torch.distributed as dist

    from repro_torch.core import sharding as SH
    from repro_torch.models import moe as MOE
    from repro_torch.optim.quantized import QLeaf
    from repro_torch.runtime import sharded as SD

    mesh = act_sharding.mesh
    specs = SH.map_specs(lambda ns: ns.spec, grad_shardings)
    roles, block_fns = SD.plan_layout(arch, specs, mesh, act_sharding.spec)
    lays = SD.layouts(grad_shardings, roles)
    world = mesh.size()
    _, opt_update = optimizer
    loss_fn = make_loss_fn(arch, impl=impl, remat=remat,
                           mtp_weight=mtp_weight, block_fns=block_fns)

    def rows_of(x, i, per, dev):
        x = torch.as_tensor(x)[i * per:(i + 1) * per]
        return x[SH.batch_slice(act_sharding, per)].to(dev)

    # the MoE aux loss over the global batch, as the reference's
    split = SD.batch_group(mesh, act_sharding.spec)

    def local_grads(params, locals_, tok, lab, fe):
        live = [t.detach().requires_grad_() for t in locals_]
        with (MOE.batch_split(*split) if split else
              contextlib.nullcontext()):
            work = SD.working_tree(params, live, lays, mesh)
            total, ce = loss_fn(work, tok, lab, fe)
            grads = torch.autograd.grad(total, live, allow_unused=True)
        return total.detach(), ce.detach(), [
            torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, live)]

    def train_step(params, opt_state, batch):
        p_leaves = tree.leaves(params)
        locals_ = [p.to_local() for p in p_leaves]
        dev = locals_[0].device
        n = torch.as_tensor(batch["tokens"]).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"{microbatches} microbatches")
        per = n // microbatches
        grads = total = ce = None
        for i in range(microbatches):
            tok, lab = (rows_of(batch[k], i, per, dev)
                        for k in ("tokens", "labels"))
            fe = batch.get("frontend")
            fe = None if fe is None else rows_of(fe, i, per, dev)
            t, c, g = local_grads(params, locals_, tok, lab, fe)
            if microbatches == 1:
                for j, x in enumerate(g):   # each leaf's own dtype freed
                    g[j] = x.float()        # as its fp32 copy is made
                grads, total, ce = g, t, c
                break
            if grads is None:
                grads = [torch.zeros(x.shape, dtype=torch.float32,
                                     device=dev) for x in locals_]
                total = ce = torch.zeros((), dtype=torch.float32, device=dev)
            for acc, x in zip(grads, g):
                acc.add_(x.float() / microbatches)
            del g
            total = total + t / microbatches
            ce = ce + c / microbatches
        metrics_t = torch.stack([total, ce])
        dist.all_reduce(metrics_t)
        total, ce = metrics_t[0] / world, metrics_t[1] / world
        gnorm = SD.global_norm(grads, lays, mesh)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
        quantized = any(isinstance(x, QLeaf)
                        for x in tree.leaves(opt_state.mu))
        if not quantized:
            mu = tree.map(lambda m: m.to_local(), opt_state.mu)
            nu = (None if opt_state.nu is None
                  else tree.map(lambda m: m.to_local(), opt_state.nu))
            p_local = tree.unflatten(params, locals_)
            updates, new = opt_update(tree.unflatten(params, grads),
                                      O.OptState(opt_state.step, mu, nu),
                                      p_local)
            del grads
            O.apply_updates(p_local, updates)
        else:
            # int8 moments are blocks of the whole flattened leaf: update
            # the gathered leaves, then keep this rank's shards
            def full_q(q):
                return QLeaf(SD.whole(q.q), SD.whole(q.scale), q.shape,
                             q.signed)
            mu_f = tree.map(full_q, opt_state.mu)
            nu_f = tree.map(full_q, opt_state.nu)
            g_full = [SD.gather_full(g, mesh, lay.placements)
                      for g, lay in zip(grads, lays)]
            del grads
            p_full = [SD.whole(p) for p in p_leaves]
            updates, new = opt_update(tree.unflatten(params, g_full),
                                      O.OptState(opt_state.step, mu_f, nu_f),
                                      tree.unflatten(params, p_full))
            for dq, fq in zip(tree.leaves(opt_state.mu) +
                              tree.leaves(opt_state.nu),
                              tree.leaves(mu_f) + tree.leaves(nu_f)):
                for d, f in ((dq.q, fq.q), (dq.scale, fq.scale)):
                    d.to_local().copy_(SD.local_of(f, d))
            with torch.no_grad():
                for x, u, p in zip(locals_, tree.leaves(updates), p_leaves):
                    x.copy_(x.float().add_(SD.local_of(u, p)))
        opt_state = O.OptState(new.step, opt_state.mu, opt_state.nu,
                               opt_state.extra)
        metrics = {"loss": total, "ce": ce, "grad_norm": gnorm,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step


def make_paged_prefill_step(arch: ArchConfig, *, impl: str = "xla",
                            sampler=None, block_fns=None):
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
    the final chunk of a prompt).  ``block_fns``: ``lm_apply``'s (a placed
    engine's tensor-parallel and pool-gathering blocks,
    ``serving/placement.py``); so for the decode step."""
    def _last_logits(params, cache, tokens, positions, block_tables,
                     new_lens, slot_ids):
        out = T.lm_apply(params, arch, tokens, cache=cache,
                         positions=positions, block_tables=block_tables,
                         new_lens=new_lens, slot_ids=slot_ids, impl=impl,
                         block_fns=block_fns)
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
                           sampler=None, block_fns=None):
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
                         slot_ids=slot_ids, impl=impl, block_fns=block_fns)
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


def make_slot_admit_step(arch: ArchConfig, *, block_fns=None):
    """-> admit(params, cache, slot_id[, frontend]) -> cache.  Resets one
    engine slot's rows in every slot-state pool on admission, in place:
    mamba2 state zeroed; cross-attn K/V zeroed or computed once from the
    request's ``frontend`` patch embeddings (1, T, d_model); wdec encoder
    K/V zeroed or computed by running the encoder ONCE over the request's
    frame embeddings (see transformer.admit_slot).  No-op for paged block
    pools.  ``block_fns``: the placed engine's (its encoder blocks')."""
    def slot_admit_step(params, cache, slot_id, frontend=None):
        # slot_id is the engine's slot index, a host int: int() reads no
        # device value
        return T.admit_slot(params, arch, cache, int(slot_id),  # reprolint: disable=step-host-sync
                            frontend=frontend, block_fns=block_fns)
    return slot_admit_step

"""StackedLM: composes an ArchConfig's segment pattern into init/apply
(twin of ``repro/models/transformer.py``).

Params keep the reference's nesting: ``segments[i]["b{j}"]`` holds the
params of every application of that block stacked on a leading ``repeat``
axis.  The reference runs a ``lax.scan`` over that axis; the port runs a
Python loop that indexes the stacked tensors (views, no copies).

Entry points:
  init_lm(arch, device=..., generator=...)            -> params
  init_paged_cache(arch, num_blocks, block_size, ...) -> cache pools
  admit_slot(params, arch, pools, slot_id)            -> pools (row reset)
  lm_apply(params, arch, tokens, ...)                 -> LMOutput
  mtp_logits(params, arch, hidden, tokens)            -> MTP head's logits
  lm_loss(logits, labels, vocab, mask=None)           -> mean cross-entropy
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

Params = dict


class LMOutput(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Any]
    aux: torch.Tensor                        # 0-d fp32: MoE balance losses
    hidden: Optional[torch.Tensor] = None    # pre-head hidden (for MTP)


def compute_dtype(arch: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if arch.dtype == "bfloat16" else torch.float32


def param_dtype(arch: ArchConfig) -> torch.dtype:
    return torch.float32 if arch.param_dtype == "float32" else torch.bfloat16


def init_lm(arch: ArchConfig, *, device=None,
            generator: Optional[torch.Generator] = None,
            seed: int = 0) -> Params:
    """Random params with the reference ``init_lm``'s shapes, dtypes and
    distributions (truncated normals scaled by 1/sqrt(fan_in), unit norm
    scales), drawn on ``device`` from ``generator`` (default: a generator
    on that device seeded with ``seed``).  The values are not the
    reference's: to run the reference's own weights, convert them
    (``repro_torch.convert``)."""
    B.check_arch(arch)
    dev = _device.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    dt = param_dtype(arch)
    params: Params = {
        "embed": L.init_embedding(arch.padded_vocab, arch.d_model,
                                  generator=generator, device=dev, dtype=dt),
        "final_norm": B.norm_init(arch, arch.d_model, device=dev, dtype=dt),
    }
    if not arch.tie_embeddings:
        params["head"] = L.init_dense(arch.d_model, arch.padded_vocab,
                                      generator=generator, device=dev,
                                      dtype=dt)
    if any("shared_attn" in seg.blocks for seg in arch.pattern):
        params["shared"] = B.init_shared(arch, generator=generator,
                                         device=dev, dtype=dt)
    if arch.mtp:
        kw = dict(generator=generator, device=dev, dtype=dt)
        params["mtp"] = {
            "proj": L.init_dense(2 * arch.d_model, arch.d_model, **kw),
            "block": B.init_block("attn", arch, **kw),
            "norm": B.norm_init(arch, arch.d_model, device=dev, dtype=dt)}
    params["segments"] = [
        {f"b{i}": B.init_block(kind, arch, generator=generator, device=dev,
                               dtype=dt, repeat=seg.repeat)
         for i, kind in enumerate(seg.blocks)}
        for seg in arch.pattern]
    return params


def init_paged_cache(arch: ArchConfig, num_blocks: int, block_size: int, *,
                     device=None, dtype=torch.bfloat16, slots: int = 0) -> list:
    """Per-segment serving cache pools, stacked on the segment's repeat
    axis.  Two state classes, side by side (serving/cache_manager.py is
    the host side of both):
      * ``attn`` and ``moe_attn`` blocks get paged KV block pools,
        ``{"k": (R, NB, BS, Hkv, D), "v": ...}``: no batch axis — the pool
        is shared by every in-flight request and indexed through
        per-request block tables (layers.paged_attention).  So do
        ``shared_attn`` blocks, at the shared block's widths: the repeat
        axis gives each application of the shared weights its own pool;
        ``mla`` and ``mla_dense`` blocks get latent block pools,
        ``{"c_kv": (R, NB, BS, kv_lora_rank), "k_rope": (R, NB, BS,
        qk_rope_head_dim)}``, paged the same way
        (mla.mla_paged_attention);
      * ``mamba2`` blocks get slot-indexed state pools, ``{"conv_x": (R,
        slots+1, K, d_inner), ..., "ssm": (R, slots+1, H, P, N)}`` in
        float32: one row per engine slot plus a reserved null row for
        inactive batch rows.  ``slots`` must be > 0 for such archs."""
    dev = _device.resolve(device)
    return [{f"b{i}": B.init_paged_block_cache(kind, arch, num_blocks,
                                               block_size, device=dev,
                                               dtype=dtype, repeat=seg.repeat,
                                               slots=slots)
             for i, kind in enumerate(seg.blocks)}
            for seg in arch.pattern]


def admit_slot(params: Params, arch: ArchConfig, pools: list,
               slot_id: int) -> list:
    """Reset one engine slot's rows across every slot-state pool, in place
    (paged KV and latent block pools pass through untouched — block reuse
    is the allocator's business).  mamba2 rows are zeroed: a fresh recurrent
    state for the admitted request; recompute-style preemption re-admits
    through here, so the re-prefill starts from a clean h0.  The
    reference's other slot-state kinds (cross_attn, wdec) are not ported
    and raise."""
    for si, seg in enumerate(arch.pattern):
        for bi, kind in enumerate(seg.blocks):
            if kind == "mamba2":
                for t in pools[si][f"b{bi}"].values():
                    t[:, slot_id].zero_()
            elif kind not in B.PORTED_KINDS:
                raise NotImplementedError(f"admit_slot: block kind {kind!r} "
                                          f"is not ported")
    return pools


def _take(tree, r: int):
    """Application ``r`` of a repeat-stacked param/cache dict (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return tree[r]


# per-layer activation checkpointing of the whole-sequence forward, by the
# reference's names (``REMAT_POLICIES``): "full" recomputes the layer in
# the backward; "selective" saves the outputs of the matrix products
# without batch dims (the dense projections, ``aten.mm``) and recomputes
# the rest, as ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``
# does.  The reference applies the dots policy to any value other than
# "none" and "full"; the port refuses names it does not know.
REMAT_POLICIES = ("none", "full", "selective")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` checkpointed by policy ``remat`` (one layer's body)."""
    if remat == "none":
        return fn
    context_fn = (_ckpt.noop_context_fn if remat == "full" else
                  functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                    _save_dots))
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def lm_apply(params: Params, arch: ArchConfig, tokens: torch.Tensor, *,
             cache: Optional[list] = None,
             positions: Optional[torch.Tensor] = None,
             block_tables: Optional[torch.Tensor] = None,
             new_lens: Optional[torch.Tensor] = None,
             slot_ids: Optional[torch.Tensor] = None,
             impl: str = "xla", remat: str = "none",
             return_hidden: bool = False) -> LMOutput:
    """Forward pass -> LMOutput(logits, cache, aux, hidden).

    tokens: (B, S) integer tokens.
    cache:  None => whole-sequence forward (causal self-attention over the
       S tokens, ``impl="pallas"`` through the port's flash kernel; the
       mamba2 scan through the port's SSD kernel either way).  Otherwise
       the pools from ``init_paged_cache``, with ``block_tables`` (B,
       max_blocks), per-sequence ``positions`` (B,), optional ``new_lens``
       (B,) (rows past it are padding) and, when the pattern holds mamba2
       blocks, ``slot_ids`` (B,) — each row's slot-state pool row, the
       null row (= slots) for inactive rows.  The pools are updated in
       place and returned as ``LMOutput.cache``.
    remat: per-layer checkpointing of the whole-sequence forward (one of
       ``REMAT_POLICIES``); the cached forward ignores it, as the
       reference's does.  zamba2's shared block reads ``params["shared"]``
       and the embeddings ``x0`` from every application; under remat they
       are closed over by each checkpointed body, and autograd sums their
       grads over the applications.
    aux: the MoE layers' load-balance losses summed over every layer (0
       without MoE), a 0-d fp32 tensor.
    return_hidden: also return the final-normed hidden states (B, S, D)
       that the head reads (``mtp_logits`` takes them).
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")
    if cache is not None and block_tables is None:
        raise NotImplementedError("the port's cached forward is paged: pass "
                                  "block_tables with the pools")
    cdt = compute_dtype(arch)
    x = L.embed(params["embed"], tokens.long(), arch.d_model).to(cdt)
    if positions is None and cache is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x0 = x                     # the scaled embeddings (zamba2's shared block)
    shared = params.get("shared")
    aux = 0.0
    for si, seg in enumerate(arch.pattern):
        segp = params["segments"][si]
        for r in range(seg.repeat):
            def body(x, si=si, r=r, seg=seg, segp=segp):
                aux = 0.0
                for bi, kind in enumerate(seg.blocks):
                    key = f"b{bi}"
                    c = None if cache is None else _take(cache[si][key], r)
                    x, _, a = B.apply_block(_take(segp[key], r), kind, arch,
                                            x, x0=x0, shared=shared,
                                            cache=c, positions=positions,
                                            block_tables=block_tables,
                                            new_lens=new_lens,
                                            slot_ids=slot_ids, impl=impl)
                    aux = aux + a
                return x, aux
            x, a = _remat(body, remat if cache is None else "none")(x)
            aux = aux + a
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    hidden = B.norm_apply(arch, params["final_norm"], x)
    return LMOutput(_head(params, arch, hidden), cache, aux,
                    hidden if return_hidden else None)


def _head(params: Params, arch: ArchConfig,
          hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits: the tied embedding's transpose or the untied head."""
    if arch.tie_embeddings:
        return L.unembed(params["embed"], hidden)
    return L.dense(params["head"], hidden).to(torch.float32)


def mtp_logits(params: Params, arch: ArchConfig, hidden: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction head (depth 1): the normed
    final hidden state at position t, concatenated with the embedding of
    token t+1 and projected back to d_model, goes through one ``attn``
    block at positions 0..S-1 (plain attention: the reference passes no
    ``impl`` there) and the head, so that logits[:, t] predict
    tokens[:, t+2].  -> (B, S, V) fp32."""
    mtp = params["mtp"]
    emb_next = L.embed(params["embed"],
                       torch.roll(tokens.long(), -1, dims=1),
                       arch.d_model).to(hidden.dtype)
    h = L.dense(mtp["proj"], torch.cat(
        [B.norm_apply(arch, mtp["norm"], hidden), emb_next], dim=-1))
    h, _, _ = B.apply_block(mtp["block"], "attn", arch, h,
                            positions=torch.arange(h.shape[1],
                                                   device=h.device))
    return _head(params, arch, h)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in fp32 over (B, S) positions (twin of the
    reference's ``lm_loss``): padded-vocab logits (ids >= ``vocab``) masked
    to -1e30, logsumexp as m + log(sum(exp(logits - m))) minus the target
    logit; with ``mask`` (B, S), sum(nll * mask) / max(sum(mask), 1)."""
    V = logits.shape[-1]
    logits = logits.float()
    if V > vocab:
        vid = torch.arange(V, device=logits.device)
        logits = torch.where(vid < vocab, logits, L.NEG_INF)
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

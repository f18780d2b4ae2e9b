"""StackedLM: composes an ArchConfig's segment pattern into init/apply
(twin of ``repro/models/transformer.py``).

Params keep the reference's nesting: ``segments[i]["b{j}"]`` holds the
params of every application of that block stacked on a leading ``repeat``
axis.  The reference runs a ``lax.scan`` over that axis; the port runs a
Python loop that indexes the stacked tensors (views, no copies).

Entry points:
  init_lm(arch, device=..., generator=...)            -> params
  init_paged_cache(arch, num_blocks, block_size, ...) -> cache pools
  admit_slot(params, arch, pools, slot_id, frontend)  -> pools (slot rows)
  encode_frontend(params, arch, frontend)             -> encoder output
  lm_apply(params, arch, tokens, frontend=..., ...)   -> LMOutput
  mtp_logits(params, arch, hidden, tokens)            -> MTP head's logits
  lm_loss(logits, labels, vocab, mask=None)           -> mean cross-entropy
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import device as _device
from repro_torch import tree
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


def sinusoidal_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """fp32 sinusoidal embeddings of integer positions of any shape ->
    positions.shape + (d_model,): sin in the even columns, cos in the odd
    ones (an odd d_model has one sin column more than cos columns)."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)
    angle = pos / 10000.0 ** (dim / d_model)
    pe = torch.zeros(positions.shape + (d_model,), dtype=torch.float32,
                     device=positions.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle[..., :d_model // 2])
    return pe


def sinusoidal_positions(seq_len: int, d_model: int, *,
                         device=None) -> torch.Tensor:
    return sinusoidal_at(torch.arange(seq_len, device=device), d_model)


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
    if arch.encoder is not None:
        params["encoder"] = {
            "segments": [{"b0": B.init_block(
                "enc_attn", arch, generator=generator, device=dev, dtype=dt,
                repeat=arch.encoder.n_layers)}],
            "final_norm": B.norm_init(arch, arch.d_model, device=dev,
                                      dtype=dt)}
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
        inactive batch rows.  ``slots`` must be > 0 for such archs.
        ``cross_attn`` blocks get slot rows of cross K/V (the frontend's
        projections), and ``wdec`` blocks both classes: a paged
        self-attention pool and slot rows of the encoder's cross K/V."""
    dev = _device.resolve(device)
    return [{f"b{i}": B.init_paged_block_cache(kind, arch, num_blocks,
                                               block_size, device=dev,
                                               dtype=dtype, repeat=seg.repeat,
                                               slots=slots)
             for i, kind in enumerate(seg.blocks)}
            for seg in arch.pattern]


def _apply_segment(segp: Params, blocks: tuple, repeat: int,
                   arch: ArchConfig, x: torch.Tensor, *, cache=None,
                   remat: str = "none", block_fns: Optional[dict] = None,
                   **kw):
    """Every application of one segment's blocks in order -> (x, aux);
    ``remat`` checkpoints each application's body (the reference's
    checkpointed scan body), and only the whole-sequence forward takes
    it.  ``block_fns`` maps a block index to the function that applies
    that block in place of ``blocks.apply_block`` (the sharded train
    step's tensor-parallel attn block)."""
    aux = 0.0
    for r in range(repeat):
        def body(x, r=r):
            aux = 0.0
            for bi, kind in enumerate(blocks):
                key = f"b{bi}"
                c = None if cache is None else _take(cache[key], r)
                fn = (block_fns or {}).get(bi, B.apply_block)
                x, _, a = fn(_take(segp[key], r), kind, arch, x, cache=c,
                             **kw)
                aux = aux + a
            return x, aux
        x, a = _remat(body, remat if cache is None else "none")(x)
        aux = aux + a
    return x, aux


def encode_frontend(params: Params, arch: ArchConfig,
                    frontend: torch.Tensor, *, impl: str = "xla",
                    remat: str = "none",
                    block_fns: Optional[dict] = None) -> torch.Tensor:
    """The encoder stack over precomputed frame embeddings (B, enc_len,
    d_model) -> its output (B, enc_len, d_model) in the compute dtype:
    sinusoidal positions added, every ``enc_attn`` layer (bidirectional,
    so never the flash kernel), the final norm.  Shared by the forward's
    audio branch and by serving admission, which runs it ONCE per
    request (``admit_slot``), never per step.  ``block_fns``: {encoder
    segment: {block: fn}}, as ``lm_apply``'s for the decoder (the sharded
    step's tensor-parallel encoder blocks)."""
    cdt = compute_dtype(arch)
    enc = frontend.to(cdt)
    enc = enc + sinusoidal_positions(enc.shape[1], arch.d_model,
                                     device=enc.device).to(cdt)
    enc_p = params["encoder"]
    for si, segp in enumerate(enc_p["segments"]):
        enc, _ = _apply_segment(segp, ("enc_attn",), arch.encoder.n_layers,
                                arch, enc, remat=remat, impl=impl,
                                block_fns=(block_fns or {}).get(si))
    return B.norm_apply(arch, enc_p["final_norm"], enc)


def _scatter_cross_kv(pool: Params, slot_id: int, attn_stack: Params,
                      cfg, src: torch.Tensor) -> None:
    """Project ``src`` (T, d_model) through each application's wk / wv
    (params stacked on the segment's repeat axis) and write the result
    into this slot's rows of a (repeat, slots+1, T, Hkv, D) cross-K/V
    pool, in place, in the pool's dtype.  Shared by the cross_attn and
    wdec admission branches."""
    T = src.shape[0]
    for r in range(pool["k"].shape[0]):
        p = _take(attn_stack, r)
        # the KV heads of wk / wv: all of them, or a tensor-parallel rank's
        # (its columns of them, written into its shard of the pool)
        k = L.dense(p["wk"], src).reshape(T, -1, cfg.head_dim)
        v = L.dense(p["wv"], src).reshape(T, -1, cfg.head_dim)
        if cfg.qk_norm:
            k = L.rmsnorm(p["k_norm"], k)
        pool["k"][r, slot_id] = k.to(pool["k"].dtype)
        pool["v"][r, slot_id] = v.to(pool["v"].dtype)


def admit_slot(params: Params, arch: ArchConfig, pools: list, slot_id: int,
               frontend: Optional[torch.Tensor] = None,
               block_fns: Optional[dict] = None) -> list:
    """Reset one engine slot's rows across every slot-state pool, in place
    (paged KV and latent block pools pass through untouched — block reuse
    is the allocator's business).  Recompute-style preemption re-admits
    through here, so a resumed request gets its rows anew.

    mamba2 rows are zeroed: a fresh recurrent state, so the re-prefill
    starts from h0 = 0.  cross_attn rows are zeroed, or — when the
    admitted request carries ``frontend`` patch embeddings (1, T, d_model)
    — filled with each layer's cross K/V projections of them, computed
    here once, never per step.  wdec rows get the encoder's cross K/V: the
    ``frontend`` frame embeddings (1, enc_len, d_model) go through the
    encoder once, then every decoder layer's cross projections of its
    output are written into this slot's rows; without a frontend they are
    zeroed.  ``block_fns``: ``lm_apply``'s; admission runs the encoder's
    (its ``"encoder"`` entry).  Under tensor parallelism ``params`` and
    ``pools`` are a rank's: its wk / wv columns write its own heads into
    its shard of a cross-K/V pool, and zeroing a slot is the same on any
    shard."""
    cdt = compute_dtype(arch)
    srcs = {}          # what each kind's cross K/V are projected from
    if frontend is not None:
        frontend = torch.as_tensor(frontend,
                                   device=tree.leaves(pools)[0].device)
        srcs["cross_attn"] = frontend[0].to(cdt)
        if any("wdec" in seg.blocks for seg in arch.pattern):
            srcs["wdec"] = encode_frontend(
                params, arch, frontend,
                block_fns=(block_fns or {}).get("encoder"))[0]
    for si, seg in enumerate(arch.pattern):
        segp = params["segments"][si]
        for bi, kind in enumerate(seg.blocks):
            key = f"b{bi}"
            if kind not in ("mamba2", "cross_attn", "wdec"):
                continue
            pool = pools[si][key]["cross"] if kind == "wdec" \
                else pools[si][key]
            if kind in srcs:
                _scatter_cross_kv(pool, slot_id, segp[key][
                    "attn" if kind == "cross_attn" else "xattn"],
                    B.cross_cfg_for(arch, kind), srcs[kind])
            else:
                for t in pool.values():
                    t[:, slot_id].zero_()
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
             frontend: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             block_tables: Optional[torch.Tensor] = None,
             new_lens: Optional[torch.Tensor] = None,
             slot_ids: Optional[torch.Tensor] = None,
             impl: str = "xla", remat: str = "none",
             return_hidden: bool = False,
             block_fns: Optional[dict] = None) -> LMOutput:
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
    frontend: the whole-sequence forward's precomputed modality
       embeddings: for a vision arch (B, n_img_tokens, d_model) patch
       embeddings, the cross_attn blocks' K/V input; for an audio arch
       (B, enc_len, d_model) frame embeddings, run through the encoder
       (``encode_frontend``) whose output the wdec blocks attend to.  The
       serving path reads the slot rows admission wrote instead.  An arch
       with an encoder adds sinusoidal positions to the decoder's
       embeddings: of 0..S-1 in the forward, of each row's own
       positions[b] + 0..S-1 on the paged path.
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
    block_fns: {segment index: {block index: fn}}, a function with
       ``blocks.apply_block``'s signature that applies that block in its
       place (the sharded train step's tensor-parallel blocks,
       ``runtime/sharded.py``), and under ``"encoder"`` the same for the
       encoder's segments (``encode_frontend``).  A stacked leaf of
       ``params`` may be any object whose ``[r]`` gives application r's
       tensor (the sharded step gathers each application's weights on use
       that way).
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")
    if cache is not None and block_tables is None:
        raise NotImplementedError("the port's cached forward is paged: pass "
                                  "block_tables with the pools")
    cdt = compute_dtype(arch)
    cross_input = None
    if frontend is not None and arch.frontend == "vision":
        cross_input = frontend.to(cdt)
    elif frontend is not None and arch.frontend == "audio":
        cross_input = encode_frontend(params, arch, frontend, impl=impl,
                                      remat=remat,
                                      block_fns=(block_fns or {}).get(
                                          "encoder"))
    x = L.embed(params["embed"], tokens.long(), arch.d_model).to(cdt)
    if arch.encoder is not None:   # whisper's decoder: absolute positions
        S = x.shape[1]
        if cache is None:
            pe = sinusoidal_positions(S, arch.d_model, device=x.device)
        else:                      # each row at its own offset: (B, S, D)
            pe = sinusoidal_at(positions[:, None] + torch.arange(
                S, device=x.device), arch.d_model)
        x = x + pe.to(cdt)
    if positions is None and cache is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x0 = x                     # the scaled embeddings (zamba2's shared block)
    aux = 0.0
    for si, seg in enumerate(arch.pattern):
        x, a = _apply_segment(
            params["segments"][si], seg.blocks, seg.repeat, arch, x,
            cache=None if cache is None else cache[si], remat=remat,
            block_fns=(block_fns or {}).get(si), x0=x0,
            cross_input=cross_input, shared=params.get("shared"),
            positions=positions, block_tables=block_tables,
            new_lens=new_lens, slot_ids=slot_ids, impl=impl)
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
               tokens: torch.Tensor, mtp_fn=None) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction head (depth 1): the normed
    final hidden state at position t, concatenated with the embedding of
    token t+1 and projected back to d_model, goes through one ``attn``
    block at positions 0..S-1 (plain attention: the reference passes no
    ``impl`` there) and the head, so that logits[:, t] predict
    tokens[:, t+2].  -> (B, S, V) fp32.  ``mtp_fn(mtp, arch, z,
    positions)``, where given, applies the projection and the block to
    the concatenation ``z`` in their place (the sharded step's
    tensor-parallel head, ``runtime/sharded.py``)."""
    mtp = params["mtp"]
    emb_next = L.embed(params["embed"],
                       torch.roll(tokens.long(), -1, dims=1),
                       arch.d_model).to(hidden.dtype)
    z = torch.cat([B.norm_apply(arch, mtp["norm"], hidden), emb_next],
                  dim=-1)
    positions = torch.arange(z.shape[1], device=z.device)
    if mtp_fn is not None:
        return _head(params, arch, mtp_fn(mtp, arch, z, positions))
    h, _, _ = B.apply_block(mtp["block"], "attn", arch,
                            L.dense(mtp["proj"], z), positions=positions)
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

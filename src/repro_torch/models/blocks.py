"""Block registry: init / apply / paged-cache-init per block kind (twin of
``repro/models/blocks.py``).  The port implements every kind of the
reference: ``attn`` — norm, GQA self-attention with RoPE and optional
qk-norm, norm, the MLP (SwiGLU, GeGLU, GELU or ReLU) — ``moe_attn`` — the
same attention, then the MoE FFN (``moe.py``) — ``mla`` and ``mla_dense``
— multi-head latent attention (``mla.py``), then the MoE FFN or the dense
MLP — ``mamba2`` — norm, Mamba2 SSD mixer — ``shared_attn`` — zamba2's
weight-shared transformer block over concat(x, x0) at width 2 * d_model,
whose weights live once in ``init_shared`` and whose per-application
params are the projection ``app_proj`` back to d_model — ``enc_attn`` —
an encoder block: bidirectional self-attention without RoPE, the MLP at
the encoder's d_ff — ``cross_attn`` — llama-vision's gated cross
attention over the frontend (or its slot rows), then an MLP scaled by
tanh(mlp_gate) — and ``wdec`` — whisper's decoder block: causal
self-attention without RoPE, cross attention over the encoder output (or
its slot rows), the MLP, three norms.  The norms are RMSNorm or
LayerNorm by ``arch.norm``.  Any other kind raises
``NotImplementedError`` naming it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE

Params = dict
PORTED_KINDS = ("attn", "moe_attn", "mla", "mla_dense", "mamba2",
                "shared_attn", "enc_attn", "cross_attn", "wdec")
# the kinds that run GQA self-attention (``layers.attention``; ``enc_attn``
# bidirectional, without RoPE), those that run latent attention
# (``mla.py``), and those whose FFN is the MoE layer
ATTN_KINDS = ("attn", "moe_attn")
MLA_KINDS = ("mla", "mla_dense")
MOE_KINDS = ("moe_attn", "mla")


def check_arch(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming any block kind of ``arch`` the
    port does not know (not in ``PORTED_KINDS``).  Every MLP act, norm,
    encoder and frontend the reference takes is ported, and so is the MTP
    head (``transformer.mtp_logits``)."""
    kinds = sorted({k for seg in arch.pattern for k in seg.blocks})
    missing = [k for k in kinds if k not in PORTED_KINDS]
    if missing:
        raise NotImplementedError(
            f"{arch.name}: block kind(s) {missing} are not ported to "
            f"repro_torch (ported: {list(PORTED_KINDS)})")


def norm_init(arch: ArchConfig, d: int, *, device, dtype,
              repeat: Optional[int] = None) -> Params:
    """LayerNorm params when ``arch.norm`` is "layernorm", else RMSNorm's
    (the reference's rule)."""
    init = L.init_layernorm if arch.norm == "layernorm" else L.init_rmsnorm
    return init(d, device=device, dtype=dtype, repeat=repeat)


def norm_apply(arch: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return (L.layernorm(p, x) if arch.norm == "layernorm"
            else L.rmsnorm(p, x))


def attn_cfg_for(arch: ArchConfig, *, causal=True, use_rope=True,
                 gated=False, d_model: Optional[int] = None,
                 n_heads: Optional[int] = None) -> L.AttnConfig:
    """The arch's attention; with ``d_model`` given (zamba2's shared block
    at 2 * d_model) the head dim is ``d_model // n_heads`` and every head
    has its own KV head.  ``gated``: llama-vision's tanh output gate."""
    nh = n_heads or arch.n_heads
    dm = d_model or arch.d_model
    hd = arch.resolved_head_dim if d_model is None else dm // nh
    n_kv = min(arch.n_kv_heads, nh) if d_model is None else nh
    return L.AttnConfig(
        d_model=dm, n_heads=nh, n_kv_heads=n_kv, head_dim=hd,
        rope_theta=arch.rope_theta,
        use_rope=use_rope and arch.rope_theta > 0, qk_norm=arch.qk_norm,
        causal=causal, bias=arch.attn_bias, gated=gated)


def cross_cfg_for(arch: ArchConfig, kind: str) -> L.AttnConfig:
    """The cross attention of a ``cross_attn`` block (gated) or of a
    ``wdec`` block: bidirectional, no RoPE."""
    return attn_cfg_for(arch, causal=False, use_rope=False,
                        gated=kind == "cross_attn")


def shared_cfg_for(arch: ArchConfig) -> L.AttnConfig:
    """The attention of zamba2's shared block: width 2 * d_model."""
    return attn_cfg_for(arch, d_model=2 * arch.d_model, n_heads=arch.n_heads)


def moe_cfg_for(arch: ArchConfig) -> MOE.MoEConfig:
    m = arch.moe
    return MOE.MoEConfig(
        d_model=arch.d_model, d_ff=m.d_ff, n_experts=m.n_experts,
        top_k=m.top_k, router=m.router, capacity_factor=m.capacity_factor,
        n_shared_experts=m.n_shared_experts, shared_d_ff=m.shared_d_ff,
        dense_d_ff=m.dense_d_ff, act=arch.act)


def mla_cfg_for(arch: ArchConfig) -> MLA.MLAConfig:
    m = arch.mla
    return MLA.MLAConfig(d_model=arch.d_model, n_heads=arch.n_heads,
                         q_lora_rank=m.q_lora_rank,
                         kv_lora_rank=m.kv_lora_rank,
                         qk_nope_head_dim=m.qk_nope_head_dim,
                         qk_rope_head_dim=m.qk_rope_head_dim,
                         v_head_dim=m.v_head_dim, rope_theta=arch.rope_theta)


def ssm_cfg_for(arch: ArchConfig) -> M2.Mamba2Config:
    s = arch.ssm
    return M2.Mamba2Config(d_model=arch.d_model, d_state=s.d_state,
                           head_dim=s.head_dim, expand=s.expand,
                           n_groups=s.n_groups, d_conv=s.d_conv, chunk=s.chunk)


def init_block(kind: str, arch: ArchConfig, *, generator, device, dtype,
               repeat: Optional[int] = None) -> Params:
    """Params of one block kind; ``repeat`` stacks that many independent
    blocks on a leading axis (a segment's repeat axis)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    d = arch.d_model
    kw = dict(device=device, dtype=dtype, repeat=repeat)
    if kind == "mamba2":
        return {"norm": norm_init(arch, d, **kw),
                "mixer": M2.init_mamba2(ssm_cfg_for(arch),
                                        generator=generator, **kw)}
    if kind == "shared_attn":
        # per-application params only (the shared block's 2d-wide output
        # projected back to d); the shared weights live in init_shared
        return {"app_proj": L.init_dense(2 * d, d, generator=generator,
                                         **kw)}
    gkw = dict(generator=generator, **kw)
    if kind == "cross_attn":
        lead = () if repeat is None else (repeat,)
        return {"norm1": norm_init(arch, d, **kw),
                "attn": L.init_attention(cross_cfg_for(arch, kind), **gkw),
                "norm2": norm_init(arch, d, **kw),
                "mlp": L.init_mlp(d, arch.d_ff, act=arch.act, **gkw),
                "mlp_gate": torch.zeros(lead, dtype=dtype, device=device)}
    if kind == "wdec":
        return {"norm1": norm_init(arch, d, **kw),
                "attn": L.init_attention(attn_cfg_for(arch, use_rope=False),
                                         **gkw),
                "norm2": norm_init(arch, d, **kw),
                "xattn": L.init_attention(cross_cfg_for(arch, kind), **gkw),
                "norm3": norm_init(arch, d, **kw),
                "mlp": L.init_mlp(d, arch.d_ff, act=arch.act, **gkw)}
    attn = (MLA.init_mla(mla_cfg_for(arch), generator=generator, **kw)
            if kind in MLA_KINDS else
            L.init_attention(attn_cfg_for(arch), generator=generator, **kw))
    # an encoder block's MLP takes the encoder's d_ff
    d_ff = (arch.encoder.d_ff if kind == "enc_attn" and arch.encoder
            else arch.d_ff)
    ffn = ({"moe": MOE.init_moe(moe_cfg_for(arch), generator=generator,
                                **kw)}
           if kind in MOE_KINDS else
           {"mlp": L.init_mlp(d, d_ff, generator=generator, act=arch.act,
                              **kw)})
    return {"norm1": norm_init(arch, d, **kw), "attn": attn,
            "norm2": norm_init(arch, d, **kw), **ffn}


def init_shared(arch: ArchConfig, *, generator, device, dtype) -> Params:
    """zamba2's shared transformer block over concat(x, x0): width 2d."""
    d2 = 2 * arch.d_model
    kw = dict(device=device, dtype=dtype)
    return {"norm1": norm_init(arch, d2, **kw),
            "attn": L.init_attention(shared_cfg_for(arch),
                                     generator=generator, **kw),
            "norm2": norm_init(arch, d2, **kw),
            "mlp": L.init_mlp(d2, arch.d_ff, generator=generator,
                              act=arch.act, **kw)}


def init_paged_block_cache(kind: str, arch: ArchConfig, num_blocks: int,
                           block_size: int, *, device,
                           dtype=torch.bfloat16,
                           repeat: Optional[int] = None,
                           slots: int = 0) -> Params:
    """Serving cache pool for one block kind (continuous-batching engine).

    ``attn`` and ``moe_attn`` get a physical KV *block pool*
    (length-indexed, paged through block tables); ``mla`` and
    ``mla_dense`` a latent (c_kv, k_rope) block pool paged the same way;
    and so does ``shared_attn`` get a KV pool at the shared block's
    widths: stacked on the segment's ``repeat`` axis, each application of
    the shared weights pages its own KV.  ``mamba2`` state is O(1) per
    request, so paging does not apply: it gets a *slot-indexed state
    pool*, ``slots`` rows plus a trailing reserved null row (see
    mamba2.mamba2_slot), in float32 whatever ``dtype`` is, like the
    reference's.  So do ``cross_attn`` blocks get slot rows of cross K/V,
    ``{"k": (R, slots+1, n_img_tokens, Hkv, D), "v": ...}`` in ``dtype``,
    written once at admission (transformer.admit_slot); and ``wdec``
    blocks carry both classes: ``{"self": a paged KV pool, "cross": slot
    rows of the encoder's K/V, (R, slots+1, encoder.seq_len, Hkv, D)}``.
    ``enc_attn`` has no serving cache (a ValueError, as the
    reference's)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    if kind in ("mamba2", "cross_attn", "wdec") and slots <= 0:
        raise ValueError(
            f"slot-state pool for {kind!r} needs slots > 0 (one state "
            f"row per engine slot + the null row)")
    lead = () if repeat is None else (repeat,)

    def rows(T):
        cfg = cross_cfg_for(arch, kind)
        shp = lead + (slots + 1, T, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
    if kind == "mamba2":
        return M2.init_mamba2_cache(ssm_cfg_for(arch), slots + 1,
                                    device=device, repeat=repeat)
    if kind == "cross_attn":
        return rows(arch.n_img_tokens)
    if kind == "wdec":
        if arch.encoder is None:
            raise ValueError(
                f"{arch.name}: wdec blocks need arch.encoder (its seq_len "
                f"sizes the per-slot cross-K/V pool)")
        return {"self": L.init_paged_attention_cache(
                    attn_cfg_for(arch, use_rope=False), num_blocks,
                    block_size, device=device, dtype=dtype, repeat=repeat),
                "cross": rows(arch.encoder.seq_len)}
    if kind in MLA_KINDS:
        return MLA.init_paged_mla_cache(mla_cfg_for(arch), num_blocks,
                                        block_size, device=device,
                                        dtype=dtype, repeat=repeat)
    if kind not in ATTN_KINDS + ("shared_attn",):
        raise ValueError(f"no paged/slot-state serving cache for block kind "
                         f"{kind!r}")
    cfg = shared_cfg_for(arch) if kind == "shared_attn" else attn_cfg_for(arch)
    return L.init_paged_attention_cache(cfg, num_blocks, block_size,
                                        device=device, dtype=dtype,
                                        repeat=repeat)


def apply_block(p: Params, kind: str, arch: ArchConfig, x: torch.Tensor, *,
                x0: Optional[torch.Tensor] = None,
                cross_input: Optional[torch.Tensor] = None,
                shared: Optional[Params] = None,
                cache: Optional[Params] = None,
                positions: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                new_lens: Optional[torch.Tensor] = None,
                slot_ids: Optional[torch.Tensor] = None,
                impl: str = "xla"):
    """-> (x, cache, aux).  ``aux`` is the MoE layer's load-balance loss
    (a 0-d fp32 tensor) for ``moe_attn`` and ``mla``, and 0.0 for the other
    kinds.  ``block_tables`` selects the paged path for the attention
    kinds (KV pools; latent pools for ``mla`` / ``mla_dense``),
    ``slot_ids`` the slot-state pool path for ``mamba2``; either pool
    ``cache`` is updated in place and returned.  ``shared_attn`` takes the
    shared block's params (``shared``) and the scaled embeddings (``x0``);
    its ``cache`` is this application's slice of the repeat-stacked pool,
    so two applications never mix their KV.  ``cross_attn`` and ``wdec``
    attend over ``cross_input`` (B, T, d_model) — the vision frontend or
    the encoder output — in the whole-sequence forward, and over their
    slot rows (``cache``, read at ``slot_ids``, never written) on the
    serving path; with neither, their cross attention runs bidirectional
    self-attention over x, as the reference's does.  ``impl="pallas"``
    runs the flash kernel in the whole-sequence causal self-attention;
    latent, bidirectional and cross attention have no kernel (nor have
    the reference's)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    if kind == "enc_attn" and (block_tables is not None or
                               slot_ids is not None):
        raise ValueError(f"continuous-batching serving unsupported for "
                         f"block kind {kind!r}")
    if kind == "cross_attn":
        h, new_cache = _cross(p["attn"], cross_cfg_for(arch, kind),
                              norm_apply(arch, p["norm1"], x), cross_input,
                              cache, slot_ids, impl)
        x = x + h
        h = L.mlp(p["mlp"], norm_apply(arch, p["norm2"], x), arch.act)
        return x + torch.tanh(p["mlp_gate"].to(h.dtype)) * h, new_cache, 0.0
    if kind == "wdec":
        h, nc_self = L.attention(p["attn"], attn_cfg_for(arch, use_rope=False),
                                 norm_apply(arch, p["norm1"], x),
                                 cache=None if cache is None else cache["self"],
                                 positions=positions,
                                 block_tables=block_tables,
                                 new_lens=new_lens, impl=impl)
        x = x + h
        h, nc_cross = _cross(p["xattn"], cross_cfg_for(arch, kind),
                             norm_apply(arch, p["norm2"], x), cross_input,
                             None if cache is None else cache["cross"],
                             slot_ids, impl)
        x = x + h
        h = L.mlp(p["mlp"], norm_apply(arch, p["norm3"], x), arch.act)
        new_cache = (None if cache is None
                     else {"self": nc_self, "cross": nc_cross})
        return x + h, new_cache, 0.0
    if kind == "mamba2":
        h, new_cache = mamba2_mixer(p["mixer"], arch,
                                    norm_apply(arch, p["norm"], x),
                                    cache=cache, slot_ids=slot_ids,
                                    new_lens=new_lens, impl=impl)
        return x + h, new_cache, 0.0
    if kind == "shared_attn":
        if shared is None or x0 is None:
            raise ValueError("shared_attn needs the shared block's params "
                             "(shared=) and the embeddings (x0=)")
        z = torch.cat([x, x0], dim=-1)
        h, new_cache = L.attention(shared["attn"], shared_cfg_for(arch),
                                   norm_apply(arch, shared["norm1"], z),
                                   cache=cache, positions=positions,
                                   block_tables=block_tables,
                                   new_lens=new_lens, impl=impl)
        z = z + h
        z = z + L.mlp(shared["mlp"], norm_apply(arch, shared["norm2"], z),
                      arch.act)
        return x + L.dense(p["app_proj"], z), new_cache, 0.0
    normed = norm_apply(arch, p["norm1"], x)
    if kind in MLA_KINDS and block_tables is not None:
        h, new_cache = MLA.mla_paged_attention(
            p["attn"], mla_cfg_for(arch), normed, cache=cache,
            positions=positions, block_tables=block_tables,
            new_lens=new_lens)
    elif kind in MLA_KINDS:
        h, new_cache = MLA.mla_attention(p["attn"], mla_cfg_for(arch),
                                         normed, cache=cache,
                                         positions=positions)
    else:
        enc = kind == "enc_attn"
        h, new_cache = L.attention(p["attn"],
                                   attn_cfg_for(arch, causal=not enc,
                                                use_rope=not enc),
                                   normed, cache=cache, positions=positions,
                                   block_tables=block_tables,
                                   new_lens=new_lens, impl=impl)
    x = x + h
    normed = norm_apply(arch, p["norm2"], x)
    if kind in MOE_KINDS:
        h, aux = MOE.moe(p["moe"], moe_cfg_for(arch), normed)
        return x + h, new_cache, aux
    return x + L.mlp(p["mlp"], normed, arch.act), new_cache, 0.0


def mamba2_mixer(p: Params, arch: ArchConfig, x: torch.Tensor, *,
                 cache: Optional[Params] = None, slot_ids=None,
                 new_lens=None, impl: str = "xla",
                 split: Optional[M2.HeadSplit] = None):
    """A mamba2 block's mixer over its normed input -> (y, cache): the
    whole-sequence forward, or the slot-state pool path (``slot_ids``);
    ``split``: this rank's heads (``mamba2.mamba2``'s)."""
    cfg = ssm_cfg_for(arch)
    if cache is None:
        return M2.mamba2(p, cfg, x, impl=impl, split=split)
    if slot_ids is None:
        raise ValueError("the port's cached mamba2 path is the slot-state "
                         "pool: pass slot_ids with the pools")
    return M2.mamba2_slot(p, cfg, x, pool=cache, slot_ids=slot_ids,
                          new_lens=new_lens, impl=impl, split=split)


def _cross(p: Params, cfg: L.AttnConfig, x: torch.Tensor, cross_input,
           rows: Optional[Params], slot_ids, impl: str):
    """A block's cross attention -> (y, rows).  On the serving path
    (``slot_ids``) it reads each batch row's slot rows of the pool
    ``rows``, which admission wrote and which stay as they are; otherwise
    it attends over ``cross_input``."""
    if slot_ids is not None:
        sid = slot_ids.long()
        y, _ = L.attention(p, cfg, x, cache={"k": rows["k"][sid],
                                             "v": rows["v"][sid]}, impl=impl)
    else:
        y, _ = L.attention(p, cfg, x, kv_input=cross_input, impl=impl)
    return y, rows

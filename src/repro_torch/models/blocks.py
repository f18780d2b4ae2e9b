"""Block registry: init / apply / paged-cache-init per block kind (twin of
``repro/models/blocks.py``).  The port implements kinds ``attn`` —
RMSNorm, GQA self-attention with RoPE and optional qk-norm, RMSNorm,
SwiGLU MLP — and ``mamba2`` — RMSNorm, Mamba2 SSD mixer — and raises
``NotImplementedError`` naming any other kind."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2

Params = dict
PORTED_KINDS = ("attn", "mamba2")


def check_arch(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming whatever part of ``arch`` the
    port does not implement yet (block kinds other than ``PORTED_KINDS``,
    other norms and activations, encoders, frontends, MTP heads)."""
    kinds = sorted({k for seg in arch.pattern for k in seg.blocks})
    missing = [k for k in kinds if k not in PORTED_KINDS]
    if missing:
        raise NotImplementedError(
            f"{arch.name}: block kind(s) {missing} are not ported to "
            f"repro_torch yet (ported: {list(PORTED_KINDS)})")
    if arch.norm != "rmsnorm":
        raise NotImplementedError(f"{arch.name}: norm {arch.norm!r} is not "
                                  f"ported (rmsnorm only)")
    if arch.act != "silu":
        raise NotImplementedError(f"{arch.name}: mlp act {arch.act!r} is not "
                                  f"ported (silu only)")
    for feature in ("encoder", "frontend", "mtp"):
        if getattr(arch, feature):
            raise NotImplementedError(f"{arch.name}: {feature} is not ported "
                                      f"to repro_torch yet")


def norm_init(arch: ArchConfig, d: int, *, device, dtype,
              repeat: Optional[int] = None) -> Params:
    if arch.norm != "rmsnorm":
        raise NotImplementedError(f"norm {arch.norm!r} is not ported")
    return L.init_rmsnorm(d, device=device, dtype=dtype, repeat=repeat)


def norm_apply(arch: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if arch.norm != "rmsnorm":
        raise NotImplementedError(f"norm {arch.norm!r} is not ported")
    return L.rmsnorm(p, x)


def attn_cfg_for(arch: ArchConfig, *, causal=True,
                 use_rope=True) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=arch.d_model, n_heads=arch.n_heads,
        n_kv_heads=min(arch.n_kv_heads, arch.n_heads),
        head_dim=arch.resolved_head_dim, rope_theta=arch.rope_theta,
        use_rope=use_rope and arch.rope_theta > 0, qk_norm=arch.qk_norm,
        causal=causal, bias=arch.attn_bias)


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
    return {"norm1": norm_init(arch, d, **kw),
            "attn": L.init_attention(attn_cfg_for(arch), generator=generator,
                                     **kw),
            "norm2": norm_init(arch, d, **kw),
            "mlp": L.init_mlp(d, arch.d_ff, generator=generator,
                              act=arch.act, **kw)}


def init_paged_block_cache(kind: str, arch: ArchConfig, num_blocks: int,
                           block_size: int, *, device,
                           dtype=torch.bfloat16,
                           repeat: Optional[int] = None,
                           slots: int = 0) -> Params:
    """Serving cache pool for one block kind (continuous-batching engine).

    ``attn`` gets a physical KV *block pool* (length-indexed, paged through
    block tables).  ``mamba2`` state is O(1) per request, so paging does
    not apply: it gets a *slot-indexed state pool*, ``slots`` rows plus a
    trailing reserved null row (see mamba2.mamba2_slot), in float32
    whatever ``dtype`` is, like the reference's."""
    if kind == "mamba2":
        if slots <= 0:
            raise ValueError(
                f"slot-state pool for {kind!r} needs slots > 0 (one state "
                f"row per engine slot + the null row)")
        return M2.init_mamba2_cache(ssm_cfg_for(arch), slots + 1,
                                    device=device, repeat=repeat)
    if kind != "attn":
        raise NotImplementedError(f"no paged serving cache for block kind "
                                  f"{kind!r} in repro_torch yet")
    return L.init_paged_attention_cache(attn_cfg_for(arch), num_blocks,
                                        block_size, device=device,
                                        dtype=dtype, repeat=repeat)


def apply_block(p: Params, kind: str, arch: ArchConfig, x: torch.Tensor, *,
                cache: Optional[Params] = None,
                positions: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                new_lens: Optional[torch.Tensor] = None,
                slot_ids: Optional[torch.Tensor] = None,
                impl: str = "xla"):
    """-> (x, cache).  ``block_tables`` selects the paged-KV path for
    ``attn``, ``slot_ids`` the slot-state pool path for ``mamba2``; either
    pool ``cache`` is updated in place and returned."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    if kind == "mamba2":
        normed = norm_apply(arch, p["norm"], x)
        if cache is None:
            h, new_cache = M2.mamba2(p["mixer"], ssm_cfg_for(arch), normed,
                                     impl=impl)
        elif slot_ids is None:
            raise ValueError("the port's cached mamba2 path is the slot-state "
                             "pool: pass slot_ids with the pools")
        else:
            h, new_cache = M2.mamba2_slot(p["mixer"], ssm_cfg_for(arch),
                                          normed, pool=cache,
                                          slot_ids=slot_ids,
                                          new_lens=new_lens, impl=impl)
        return x + h, new_cache
    h, new_cache = L.attention(p["attn"], attn_cfg_for(arch),
                               norm_apply(arch, p["norm1"], x), cache=cache,
                               positions=positions, block_tables=block_tables,
                               new_lens=new_lens, impl=impl)
    x = x + h
    h = L.mlp(p["mlp"], norm_apply(arch, p["norm2"], x), arch.act)
    return x + h, new_cache

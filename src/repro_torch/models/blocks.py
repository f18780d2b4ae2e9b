"""Block registry: init / apply / paged-cache-init per block kind (twin of
``repro/models/blocks.py``).  The port implements kind ``attn`` — RMSNorm,
GQA self-attention with RoPE and optional qk-norm, RMSNorm, SwiGLU MLP —
and raises ``NotImplementedError`` naming any other kind."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = dict
PORTED_KINDS = ("attn",)


def check_arch(arch: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming whatever part of ``arch`` the
    port does not implement yet (block kinds other than ``attn``, other
    norms and activations, encoders, frontends, MTP heads)."""
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


def init_block(kind: str, arch: ArchConfig, *, generator, device, dtype,
               repeat: Optional[int] = None) -> Params:
    """Params of one block kind; ``repeat`` stacks that many independent
    blocks on a leading axis (a segment's repeat axis)."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    d = arch.d_model
    kw = dict(device=device, dtype=dtype, repeat=repeat)
    return {"norm1": norm_init(arch, d, **kw),
            "attn": L.init_attention(attn_cfg_for(arch), generator=generator,
                                     **kw),
            "norm2": norm_init(arch, d, **kw),
            "mlp": L.init_mlp(d, arch.d_ff, generator=generator,
                              act=arch.act, **kw)}


def init_paged_block_cache(kind: str, arch: ArchConfig, num_blocks: int,
                           block_size: int, *, device,
                           dtype=torch.bfloat16,
                           repeat: Optional[int] = None) -> Params:
    """Serving KV block pool for one block kind (continuous-batching
    engine)."""
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
                impl: str = "xla"):
    """-> (x, cache).  ``block_tables`` selects the paged-KV path, whose
    pool ``cache`` is updated in place and returned."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    h, new_cache = L.attention(p["attn"], attn_cfg_for(arch),
                               norm_apply(arch, p["norm1"], x), cache=cache,
                               positions=positions, block_tables=block_tables,
                               new_lens=new_lens, impl=impl)
    x = x + h
    h = L.mlp(p["mlp"], norm_apply(arch, p["norm2"], x), arch.act)
    return x + h, new_cache

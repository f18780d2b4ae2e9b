"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), twin of
``repro/models/mla.py``.

Queries go through a low-rank down/up projection; keys and values come
from a compressed latent ``c_kv`` (kv_lora_rank) plus one rotary key
``k_rope`` shared by the heads.  Serving caches only ``(c_kv, k_rope)``
a token: in block pools paged like the KV pools of ``layers``, or in a
contiguous decode cache (``init_mla_cache``).  Both
LoRA norms (``q_norm``, ``kv_norm``) run the port's RMSNorm kernel; the
attention itself is the reference's latent-space einsum, which calls no
kernel there either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = dict


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self):
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def init_mla(cfg: MLAConfig, *, generator, device, dtype=torch.float32,
             repeat: Optional[int] = None) -> Params:
    H = cfg.n_heads
    kw = dict(generator=generator, device=device, dtype=dtype, repeat=repeat)
    nkw = dict(device=device, dtype=dtype, repeat=repeat)
    return {
        "wq_a": L.init_dense(cfg.d_model, cfg.q_lora_rank, **kw),
        "q_norm": L.init_rmsnorm(cfg.q_lora_rank, **nkw),
        "wq_b": L.init_dense(cfg.q_lora_rank, H * cfg.qk_head_dim, **kw),
        "wkv_a": L.init_dense(cfg.d_model,
                              cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw),
        "kv_norm": L.init_rmsnorm(cfg.kv_lora_rank, **nkw),
        "wk_b": L.init_dense(cfg.kv_lora_rank, H * cfg.qk_nope_head_dim, **kw),
        "wv_b": L.init_dense(cfg.kv_lora_rank, H * cfg.v_head_dim, **kw),
        "wo": L.init_dense(H * cfg.v_head_dim, cfg.d_model,
                           scale=1.0 / math.sqrt(H * cfg.v_head_dim), **kw),
    }


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, *, device,
                   dtype=torch.bfloat16,
                   repeat: Optional[int] = None) -> Params:
    """A contiguous latent decode cache: c_kv (batch, max_len,
    kv_lora_rank) and k_rope (batch, max_len, qk_rope_head_dim) in
    ``dtype``, zeroed, and the write position ``pos`` (0-d int32, 0);
    ``repeat`` stacks them on a leading axis."""
    lead = () if repeat is None else (repeat,)
    return {"c_kv": torch.zeros(lead + (batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros(lead + (batch, max_len,
                                          cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "pos": torch.zeros(lead, dtype=torch.int32, device=device)}


def init_paged_mla_cache(cfg: MLAConfig, num_blocks: int, block_size: int, *,
                         device, dtype=torch.bfloat16,
                         repeat: Optional[int] = None) -> Params:
    """Physical latent block pools shared by all requests (no batch axis;
    block 0 is the reserved null block): a block holds ``block_size``
    latent rows (c_kv, k_rope) instead of KV head vectors."""
    lead = () if repeat is None else (repeat,)
    return {"c_kv": torch.zeros(lead + (num_blocks, block_size,
                                        cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros(lead + (num_blocks, block_size,
                                          cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _latent_kv(p: Params, cfg: MLAConfig, x: torch.Tensor):
    """-> (c_kv normed, k_rope before rope): the latent projection of x."""
    kv = L.dense(p["wkv_a"], x)
    r = cfg.kv_lora_rank
    return L.rmsnorm(p["kv_norm"], kv[..., :r].contiguous()), kv[..., r:]


def _rope_key(k_rope: torch.Tensor, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """The shared rotary key (B, S, dr) at ``positions`` ((S,) or (B, S))."""
    return L.apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0, :]


def _project_q(p: Params, cfg: MLAConfig, x: torch.Tensor,
               positions: torch.Tensor, gather_q=None):
    B, S, _ = x.shape
    q_lat = L.dense(p["wq_a"], x)
    if gather_q is not None:
        q_lat = gather_q(q_lat)
    q = L.dense(p["wq_b"], L.rmsnorm(p["q_norm"], q_lat))
    q = q.reshape(B, S, cfg.n_heads, cfg.qk_head_dim)
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_rope = L.apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                          cfg.rope_theta)
    return q_nope, q_rope


MLA_CHUNK = 512


def _attend(cfg: MLAConfig, q_nope, q_rope, c_kv, k_rope, p: Params, *,
            q_positions, kv_len=None):
    """Latent-space attention, the absorbed form: score_nope = (q_nope @
    wk_b^T) @ c_kv^T contracts in the rank-r latent space, and the context
    is taken in it before wv_b.

    q_nope: (B,S,H,dn)  q_rope: (B,S,H,dr)  c_kv: (B,T,r)  k_rope: (B,T,dr)
    q_positions: (S,) shared across the batch or (B,S) per row (paged
    serving); kv_len: None or (B,) per row.  Logits in fp32 with masked
    entries at -1e30, probabilities cast back to the latent's dtype.  When
    S * T > 1024^2 and S > MLA_CHUNK the queries go in blocks of
    MLA_CHUNK (logits B*H*MLA_CHUNK*T, not B*H*S*T), as the reference's
    scan does.
    """
    B, S, H, dn = q_nope.shape
    T = c_kv.shape[1]
    wk = p["wk_b"]["w"].reshape(cfg.kv_lora_rank, H, dn)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wk.to(q_nope.dtype))
    scale = 1.0 / math.sqrt(cfg.qk_head_dim)
    kp = torch.arange(T, device=q_nope.device)
    ckv = c_kv.to(q_nope.dtype)
    krope = k_rope.to(q_rope.dtype)
    qpb = (q_positions.expand(B, S) if q_positions.ndim == 1
           else q_positions)                                   # (B, S)

    def block(q_lat_b, q_rope_b, pos_b):
        s_nope = torch.einsum("bshr,btr->bhst", q_lat_b, ckv)
        s_rope = torch.einsum("bshd,btd->bhst", q_rope_b, krope)
        lg = (s_nope + s_rope).to(torch.float32) * scale
        mask = pos_b[:, :, None] >= kp[None, None, :]          # (B, C, T)
        if kv_len is not None:
            mask = mask & (kp[None, None, :] < kv_len[:, None, None])
        lg = torch.where(mask[:, None], lg, L.NEG_INF)
        pr = torch.softmax(lg, dim=-1).to(ckv.dtype)
        return torch.einsum("bhst,btr->bshr", pr, ckv)         # latent ctx

    if S * T > 1024 * 1024 and S > MLA_CHUNK:
        C = MLA_CHUNK
        pad = (-S) % C
        qlp = F.pad(q_lat, (0, 0, 0, 0, 0, pad))
        qrp = F.pad(q_rope, (0, 0, 0, 0, 0, pad))
        pp = F.pad(qpb, (0, pad), value=-1)                    # fully masked
        ctx_lat = torch.cat([block(qlp[:, i:i + C], qrp[:, i:i + C],
                                   pp[:, i:i + C])
                             for i in range(0, S + pad, C)], dim=1)[:, :S]
    else:
        ctx_lat = block(q_lat, q_rope, qpb)

    wv = p["wv_b"]["w"].reshape(cfg.kv_lora_rank, H, cfg.v_head_dim)
    ctx = torch.einsum("bshr,rhv->bshv", ctx_lat.to(q_nope.dtype),
                       wv.to(q_nope.dtype))
    return ctx.reshape(B, S, H * cfg.v_head_dim)


def mla_paged_attention(p: Params, cfg: MLAConfig, x: torch.Tensor, *,
                        cache: Params, positions: torch.Tensor,
                        block_tables: torch.Tensor,
                        new_lens: Optional[torch.Tensor] = None,
                        gather_q=None):
    """Latent attention over block-paged (c_kv, k_rope) pools, the MLA
    twin of ``layers.paged_attention``: new latents are written IN PLACE
    at block_tables[b, pos // BS] * BS + pos % BS (``paged_flat_indices``:
    out-of-table and padded rows divert to the null block), then attention
    runs over each row's gathered logical view with per-row causal and
    length masks, ``kv_len = positions + new_lens``.  Returns (out, cache),
    the same cache dict."""
    B, S, _ = x.shape
    NB, BS, r = cache["c_kv"].shape
    dr = cache["k_rope"].shape[-1]
    c_kv, k_rope_new = _latent_kv(p, cfg, x)
    qp, flat = L.paged_flat_indices(positions, S, block_tables, BS,
                                    new_lens=new_lens)
    k_rope_new = _rope_key(k_rope_new, qp, cfg.rope_theta)
    flat = flat.reshape(-1).to(torch.int64)
    cc = cache["c_kv"].view(NB * BS, r)
    cr = cache["k_rope"].view(NB * BS, dr)
    cc.index_copy_(0, flat, c_kv.to(cc.dtype).reshape(B * S, r))
    cr.index_copy_(0, flat, k_rope_new.to(cr.dtype).reshape(B * S, dr))
    T = block_tables.shape[1] * BS
    bt = block_tables.to(torch.int64)
    g_ckv = cache["c_kv"][bt].reshape(B, T, r)
    g_rope = cache["k_rope"][bt].reshape(B, T, dr)
    q_nope, q_rope = _project_q(p, cfg, x, qp, gather_q)
    kv_len = positions + (new_lens if new_lens is not None else S)
    ctx = _attend(cfg, q_nope, q_rope, g_ckv, g_rope, p, q_positions=qp,
                  kv_len=kv_len)
    return L.dense(p["wo"], ctx), cache


def mla_attention(p: Params, cfg: MLAConfig, x: torch.Tensor, *,
                  cache: Optional[Params] = None,
                  positions: Optional[torch.Tensor] = None, gather_q=None):
    """Causal latent attention -> (out, cache): over the whole sequence
    (``cache is None``, -> (out, None)), or over a contiguous latent cache
    {"c_kv": (B, T, r), "k_rope": (B, T, dr), "pos": 0-d int32}
    (``init_mla_cache``): the new latents and rotary keys are written IN
    PLACE at rows pos .. pos+S-1 (``layers.cache_rows``), the queries at
    those positions attend to the first pos+S rows, and ``pos`` advances
    by S in place; the cache returned is the one passed."""
    B, S = x.shape[:2]
    c_kv, k_rope = _latent_kv(p, cfg, x)
    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        k_rope = _rope_key(k_rope, positions, cfg.rope_theta)
        q_nope, q_rope = _project_q(p, cfg, x, positions, gather_q)
        ctx = _attend(cfg, q_nope, q_rope, c_kv, k_rope, p,
                      q_positions=positions)
        return L.dense(p["wo"], ctx), None
    pos = cache["pos"]
    positions = pos + torch.arange(S, device=x.device)
    k_rope = _rope_key(k_rope, positions, cfg.rope_theta)
    cc, cr = cache["c_kv"], cache["k_rope"]
    rows = L.cache_rows(pos, S, cc.shape[1])
    cc.index_copy_(1, rows, c_kv.to(cc.dtype))
    cr.index_copy_(1, rows, k_rope.to(cr.dtype))
    q_nope, q_rope = _project_q(p, cfg, x, positions, gather_q)
    ctx = _attend(cfg, q_nope, q_rope, cc, cr, p, q_positions=positions,
                  kv_len=(pos + S).expand(B))
    pos.add_(S)
    return L.dense(p["wo"], ctx), cache

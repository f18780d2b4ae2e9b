"""Core layers, in PyTorch (twin of ``repro/models/layers.py``: RMSNorm,
LayerNorm, RoPE, self-attention whole-sequence and paged, cross
attention, the MLPs, embeddings).

Convention: every layer is an ``init_*(..., generator, device) -> params``
plus an apply function taking ``(params, x, ...)``.  Params are plain
nested dicts with the reference's keys and shapes, so a JAX param pytree
converts leaf for leaf (``repro_torch.convert``).

Every RMSNorm goes through the port's Hopper kernel (``kernels.ops``); the
large matrix products stay ``torch.matmul``, as the reference left them to
XLA.  Paged attention (``_paged_sdpa``) has no kernel in the reference
either and stays plain PyTorch, and so do LayerNorm (plain jnp in the
reference), bidirectional self-attention and cross attention: the
reference runs its Pallas flash kernel only in causal self-attention
over a whole sequence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

Params = dict
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(shape, dtype, stddev, generator, device) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2] — the reference's
    ``truncated_normal(key, -2, 2)`` distribution (not its bits: torch's
    generator is not JAX's)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * stddev).to(dtype)


def init_dense(d_in: int, d_out: int, *, generator, device, bias=False,
               dtype=torch.float32, scale: Optional[float] = None,
               repeat: Optional[int] = None) -> Params:
    """``repeat`` stacks independent draws on a leading axis (a segment's
    repeat axis), drawn one slice at a time to bound temporary memory."""
    stddev = scale if scale is not None else 1.0 / math.sqrt(d_in)
    if repeat is None:
        w = _normal((d_in, d_out), dtype, stddev, generator, device)
    else:
        w = torch.empty((repeat, d_in, d_out), dtype=dtype, device=device)
        for r in range(repeat):
            w[r] = _normal((d_in, d_out), dtype, stddev, generator, device)
    p = {"w": w}
    if bias:
        lead = () if repeat is None else (repeat,)
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_rmsnorm(d: int, *, device, dtype=torch.float32,
                 repeat: Optional[int] = None) -> Params:
    lead = () if repeat is None else (repeat,)
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 RMSNorm over the last axis, cast back to x.dtype — the math of
    the reference's ``layers.rmsnorm`` and of its Pallas RMSNorm kernel,
    computed by the port's Hopper kernel."""
    return kops.rmsnorm(x, p["scale"], eps)


def init_layernorm(d: int, *, device, dtype=torch.float32,
                   repeat: Optional[int] = None) -> Params:
    lead = () if repeat is None else (repeat,)
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, cast back to x.dtype.  The
    variance is the population one (``jnp.var``'s), not torch's default
    sample variance, which is d / (d - 1) times larger."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0, *,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,). float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    The head dim splits in halves (not interleaved pairs)."""
    dt = x.dtype
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * inv   # (..., S, hd/2)
    angles = angles[..., None, :]                               # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# attention (MHA / GQA / MQA, optional qk-norm, causal or bidirectional,
# optional cross-attention, optional output gate)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False
    causal: bool = True
    bias: bool = False
    gated: bool = False          # tanh-gated output (llama-vision cross blocks)
    softmax_scale: Optional[float] = None

    @property
    def q_dim(self):
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self):
        return self.n_kv_heads * self.head_dim


def init_attention(cfg: AttnConfig, *, generator, device,
                   dtype=torch.float32, repeat: Optional[int] = None) -> Params:
    kw = dict(generator=generator, device=device, bias=cfg.bias, dtype=dtype,
              repeat=repeat)
    p = {"wq": init_dense(cfg.d_model, cfg.q_dim, **kw),
         "wk": init_dense(cfg.d_model, cfg.kv_dim, **kw),
         "wv": init_dense(cfg.d_model, cfg.kv_dim, **kw),
         "wo": init_dense(cfg.q_dim, cfg.d_model,
                          scale=1.0 / math.sqrt(cfg.q_dim), **kw)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(cfg.head_dim, device=device, dtype=dtype,
                                   repeat=repeat)
        p["k_norm"] = init_rmsnorm(cfg.head_dim, device=device, dtype=dtype,
                                   repeat=repeat)
    if cfg.gated:
        lead = () if repeat is None else (repeat,)
        p["gate"] = torch.zeros(lead, dtype=dtype, device=device)
    return p


def local_groups(n_heads: int, n_groups: int, size: int,
                 rank: int) -> tuple:
    """The groups (KV heads of GQA, B/C groups of mamba2) that the heads
    of ``rank`` read, its n_heads / size heads of ``size`` ranks in order
    (head h reads group h // (n_heads / n_groups)): a contiguous range
    when it keeps the grouping (each local group serving an equal run of
    local heads), else one group a local head."""
    hl, rep = n_heads // size, n_heads // n_groups
    heads = [(rank * hl + i) // rep for i in range(hl)]
    lo, count = heads[0], heads[-1] - heads[0] + 1
    if hl % count == 0 and all(h == lo + i // (hl // count)
                               for i, h in enumerate(heads)):
        return tuple(range(lo, lo + count))
    return tuple(heads)


def _expand_kv(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,Hkv,D) -> (B,T,H,D) by broadcasting each kv head over its
    q-group (q head h reads kv head h // group)."""
    B, T, Hkv, D = t.shape
    group = n_heads // Hkv
    return t[:, :, :, None, :].expand(B, T, Hkv, group, D).reshape(
        B, T, n_heads, D)


SDPA_CHUNK = 512              # q-block size for the chunked path
SDPA_CHUNK_THRESHOLD = 1024   # chunk when S*T exceeds threshold^2


def _sdpa_dense(q, k, v, *, causal, scale, q_pos, kv_len):
    S, T = q.shape[1], k.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) * scale
    mask = None
    kp = torch.arange(T, device=q.device)
    if causal:
        qp = q_pos if q_pos is not None else torch.arange(S, device=q.device)
        mask = qp[:, None] >= kp[None, :]              # (S, T)
    if kv_len is not None:
        valid = kp < kv_len                            # (T,)
        mask = valid[None, :] if mask is None else (mask & valid[None, :])
    if mask is not None:
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_chunked(q, k, v, *, causal, scale, q_pos, kv_len,
                  chunk=SDPA_CHUNK):
    """Loop over query blocks: peak logits memory B*H*chunk*T instead of
    B*H*S*T (the reference's ``lax.scan`` over blocks)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    qp = q_pos if q_pos is not None else torch.arange(S, device=q.device)
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        qp = F.pad(qp, (0, pad), value=-1)             # -1 => fully masked
    kp = torch.arange(T, device=q.device)
    outs = []
    for i in range(q.shape[1] // C):
        qb, pb = q[:, i * C:(i + 1) * C], qp[i * C:(i + 1) * C]
        lg = torch.einsum("bchd,bthd->bhct", qb, k).to(torch.float32) * scale
        if causal:
            mask = pb[:, None] >= kp[None, :]
        else:
            mask = (pb[:, None] >= 0) & torch.ones((1, T), dtype=torch.bool,
                                                   device=q.device)
        if kv_len is not None:
            mask = mask & (kp[None, :] < kv_len)
        lg = torch.where(mask[None, None], lg, NEG_INF)
        pr = torch.softmax(lg, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhct,bthd->bchd", pr, v))
    return torch.cat(outs, dim=1)[:, :S]


def _sdpa(q, k, v, *, causal: bool, scale: float, q_pos=None, kv_len=None):
    """q: (B,S,H,D); k,v: (B,T,Hkv,D) with Hkv | H.  Plain PyTorch path
    (the reference's 'xla' impl); switches to the q-block-chunked form when
    the logits tensor would be large.  ``kv_len`` masks slots >= kv_len."""
    B, S, H, D = q.shape
    T = k.shape[1]
    k, v = _expand_kv(k.to(q.dtype), H), _expand_kv(v.to(q.dtype), H)
    if S * T > SDPA_CHUNK_THRESHOLD ** 2 and S > SDPA_CHUNK:
        return _sdpa_chunked(q, k, v, causal=causal, scale=scale,
                             q_pos=q_pos, kv_len=kv_len)
    return _sdpa_dense(q, k, v, causal=causal, scale=scale, q_pos=q_pos,
                       kv_len=kv_len)


def _paged_sdpa(q, k, v, *, scale: float, q_pos, kv_len):
    """SDPA with *per-sequence* causal masks: q_pos (B,S), kv_len (B,).
    Masked entries get exactly zero probability (exp underflows)."""
    T = k.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) * scale
    kp = torch.arange(T, device=q.device)
    mask = q_pos[:, :, None] >= kp[None, None, :]             # (B,S,T)
    mask = mask & (kp[None, None, :] < kv_len[:, None, None])
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def paged_flat_indices(positions: torch.Tensor, seq: int,
                       block_tables: torch.Tensor, block_size: int,
                       new_lens: Optional[torch.Tensor] = None):
    """Logical->physical paging arithmetic.

    Returns (q_pos (B, S), flat (B, S)): per-token absolute positions and
    flat row indices into an (NB * block_size, ...) pool for ``seq`` new
    tokens starting at positions[b].  Out-of-table writes (position beyond
    the table's capacity) and padded rows (>= new_lens[b]) divert to the
    null block's scratch rows — clamping them into a live block would
    silently overwrite resident state."""
    ar = torch.arange(seq, device=positions.device)
    qp = positions[:, None] + ar[None, :]                      # (B, S)
    logical = qp // block_size
    width = block_tables.shape[1]
    blk = torch.gather(block_tables, 1,
                       torch.clamp(logical, max=width - 1).to(torch.int64))
    flat = blk * block_size + qp % block_size                  # (B, S)
    flat = torch.where(logical < width, flat, qp % block_size)
    if new_lens is not None:
        valid = ar[None, :] < new_lens[:, None]
        flat = torch.where(valid, flat, (ar % block_size)[None, :])
    return qp, flat


def paged_attention(p: Params, cfg: AttnConfig, x: torch.Tensor, *,
                    cache: Params, positions: torch.Tensor,
                    block_tables: torch.Tensor,
                    new_lens: Optional[torch.Tensor] = None):
    """Self-attention over a block-paged KV pool (vLLM-style paged KV).

    cache: {"k": (NB, BS, Hkv, D), "v": ...} — a physical block pool shared
    by every request; ``block_tables`` (B, max_blocks) maps each sequence's
    logical block j to a physical block (block 0 is the null block).
    ``positions`` (B,) is each sequence's token count before this call;
    ``new_lens`` (B,) < S marks rows past it as padding.

    The new K/V rows are written into the pools IN PLACE (``index_copy_``
    on the flat (NB*BS, Hkv, D) view) — the reference returns an updated
    copy and donates the old one; the returned cache is the same dict.
    Padded and overrun rows land in the null block's scratch rows, where
    duplicate indices may race; nothing ever reads those rows unmasked.
    """
    B, S, _ = x.shape
    NB, BS, Hkv, D = cache["k"].shape
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    qp, flat = paged_flat_indices(positions, S, block_tables, BS,
                                  new_lens=new_lens)
    if cfg.use_rope:
        q = apply_rope(q, qp, cfg.rope_theta)
        k = apply_rope(k, qp, cfg.rope_theta)
    flat = flat.reshape(-1).to(torch.int64)                    # (B*S,)
    ck = cache["k"].view(NB * BS, Hkv, D)
    cv = cache["v"].view(NB * BS, Hkv, D)
    ck.index_copy_(0, flat, k.to(ck.dtype).reshape(B * S, Hkv, D))
    cv.index_copy_(0, flat, v.to(cv.dtype).reshape(B * S, Hkv, D))
    # gather each sequence's pages back into logical order
    T = block_tables.shape[1] * BS
    bt = block_tables.to(torch.int64)
    gk = cache["k"][bt].reshape(B, T, Hkv, D).to(q.dtype)
    gv = cache["v"][bt].reshape(B, T, Hkv, D).to(q.dtype)
    scale = cfg.softmax_scale or (1.0 / math.sqrt(cfg.head_dim))
    kv_len = positions + (new_lens if new_lens is not None else S)
    out = _paged_sdpa(q, _expand_kv(gk, cfg.n_heads),
                      _expand_kv(gv, cfg.n_heads), scale=scale, q_pos=qp,
                      kv_len=kv_len)
    y = dense(p["wo"], out.reshape(B, S, cfg.q_dim))
    return y, cache


def attention(p: Params, cfg: AttnConfig, x: torch.Tensor, *,
              kv_input: Optional[torch.Tensor] = None,
              cache: Optional[Params] = None,
              positions: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              new_lens: Optional[torch.Tensor] = None,
              impl: str = "xla"):
    """Self- or cross-attention -> (y, cache).

    Self-attention runs over the whole sequence (``cache is None``), paged
    over a block pool when ``block_tables`` is given, or over a contiguous
    decode cache {"k", "v": (B, T, Hkv, D), "pos": 0-d int32}
    (``init_attention_cache``): the new k / v rows are written IN PLACE at
    ``pos`` .. pos+S-1 (an ``index_copy_`` whose indices stay on the
    device; a write past T starts at T - S, as the reference's
    ``dynamic_update_slice`` clamps), the queries attend causally to the
    cache's first pos+S rows, and ``pos`` advances by S in place.  In the
    whole-sequence causal branch ``impl="pallas"`` runs the port's Hopper
    flash kernel (the reference runs its Pallas kernel there), and any
    other value, a bidirectional config or a cache, the plain PyTorch
    ``_sdpa``.

    Cross attention is taken when ``kv_input`` (B, T, d_model) is given —
    its K/V are projected here, and written into ``cache`` {"k", "v": (B,
    T, Hkv, D)} in place when one is given — or when ``cache`` is such a
    dict without ``"pos"`` (precomputed cross K/V rows: the contiguous
    decode cache's, or the serving path's slot-state rows), which is read
    and returned as it is; it is plain ``_sdpa``, unmasked.  With
    ``cfg.gated`` the output is scaled by tanh(p["gate"])."""
    if block_tables is not None:
        if cache is None or positions is None:
            raise ValueError("paged attention needs cache and positions")
        return paged_attention(p, cfg, x, cache=cache, positions=positions,
                               block_tables=block_tables, new_lens=new_lens)
    is_cross = kv_input is not None or (cache is not None and
                                        "pos" not in cache)
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
    scale = cfg.softmax_scale or (1.0 / math.sqrt(cfg.head_dim))
    new_cache = None
    if is_cross:
        if kv_input is not None:       # project the cross K/V
            T = kv_input.shape[1]
            k = dense(p["wk"], kv_input).reshape(B, T, cfg.n_kv_heads,
                                                 cfg.head_dim)
            v = dense(p["wv"], kv_input).reshape(B, T, cfg.n_kv_heads,
                                                 cfg.head_dim)
            if cfg.qk_norm:
                k = rmsnorm(p["k_norm"], k)
            if cache is not None:      # and store them
                cache["k"].copy_(k)
                cache["v"].copy_(v)
                new_cache = cache
        else:                          # precomputed cross K/V rows
            k, v = cache["k"], cache["v"]
            new_cache = cache
        if cfg.use_rope:
            q = apply_rope(q, positions if positions is not None
                           else torch.arange(S, device=x.device),
                           cfg.rope_theta)
        out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), causal=False,
                    scale=scale)
    else:
        k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            k = rmsnorm(p["k_norm"], k)
        if cache is not None:          # contiguous decode cache
            pos = cache["pos"]
            qp = pos + torch.arange(S, device=x.device)
            if cfg.use_rope:
                q = apply_rope(q, qp, cfg.rope_theta)
                k = apply_rope(k, qp, cfg.rope_theta)
            ck, cv = cache["k"], cache["v"]
            rows = cache_rows(pos, S, ck.shape[1])
            ck.index_copy_(1, rows, k.to(ck.dtype))
            cv.index_copy_(1, rows, v.to(cv.dtype))
            out = _sdpa(q, ck, cv, causal=True, scale=scale, q_pos=qp,
                        kv_len=pos + S)
            pos.add_(S)
            new_cache = cache
        else:
            if positions is None:
                positions = torch.arange(S, device=x.device)
            if cfg.use_rope:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            if impl == "pallas" and cfg.causal:
                out = kops.flash_attention(q, k, v, scale=scale)
            else:
                out = _sdpa(q, k, v, causal=cfg.causal, scale=scale)
    y = dense(p["wo"], out.reshape(B, S, cfg.q_dim))
    if cfg.gated:
        y = torch.tanh(p["gate"].to(y.dtype)) * y
    return y, new_cache


def cache_rows(pos: torch.Tensor, seq: int, max_len: int) -> torch.Tensor:
    """The int64 rows of a contiguous cache of ``max_len`` rows that ``seq``
    new tokens at ``pos`` (a 0-d device tensor) are written to: pos ..
    pos+seq-1, started at max_len - seq where they would run past the end
    (``jax.lax.dynamic_update_slice``'s clamp).  No host read of ``pos``."""
    start = torch.clamp(pos.long(), min=0, max=max_len - seq)
    return start + torch.arange(seq, device=pos.device)


def init_attention_cache(cfg: AttnConfig, batch: int, max_len: int, *,
                         device, dtype=torch.bfloat16,
                         repeat: Optional[int] = None) -> Params:
    """A contiguous decode cache: k / v rows (batch, max_len, Hkv, D) in
    ``dtype``, zeroed, and the write position ``pos`` (a 0-d int32 on the
    device, 0); ``repeat`` stacks them on a leading axis (``pos`` then
    (repeat,))."""
    lead = () if repeat is None else (repeat,)
    shp = lead + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device),
            "pos": torch.zeros(lead, dtype=torch.int32, device=device)}


def init_paged_attention_cache(cfg: AttnConfig, num_blocks: int,
                               block_size: int, *, device,
                               dtype=torch.bfloat16,
                               repeat: Optional[int] = None) -> Params:
    """Physical KV block pool shared by all requests (no batch axis; block
    0 is the reserved null block).  See :func:`paged_attention`."""
    lead = () if repeat is None else (repeat,)
    shp = lead + (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs: SwiGLU / GeGLU / plain GELU / ReLU
# ---------------------------------------------------------------------------

MLP_ACTS = ("silu", "geglu", "gelu", "relu")
GATED_ACTS = ("silu", "geglu")       # these carry a second in-projection


def init_mlp(d_model: int, d_ff: int, *, generator, device, act="silu",
             bias=False, dtype=torch.float32,
             repeat: Optional[int] = None) -> Params:
    if act not in MLP_ACTS:
        raise ValueError(f"mlp act {act!r} not in {MLP_ACTS}")
    kw = dict(generator=generator, device=device, bias=bias, dtype=dtype,
              repeat=repeat)
    # draw order: w_in, w_gate, w_out (the reference's key order)
    p = {"w_in": init_dense(d_model, d_ff, **kw)}
    if act in GATED_ACTS:
        p["w_gate"] = init_dense(d_model, d_ff, **kw)
    p["w_out"] = init_dense(d_ff, d_model, scale=1.0 / math.sqrt(d_ff), **kw)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``silu``), GeGLU (``geglu``: gelu(x W_gate) * x W_in), or an
    ungated GELU / ReLU.  GELU is the tanh form, as the reference's
    ``jax.nn.gelu(..., approximate=True)``."""
    h = dense(p["w_in"], x)
    if act == "silu":
        h = F.silu(dense(p["w_gate"], x)) * h
    elif act == "geglu":
        h = F.gelu(dense(p["w_gate"], x), approximate="tanh") * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu":
        h = F.relu(h)
    else:
        raise ValueError(f"mlp act {act!r} not in {MLP_ACTS}")
    return dense(p["w_out"], h)


# ---------------------------------------------------------------------------
# embeddings & head
# ---------------------------------------------------------------------------

def init_embedding(vocab: int, d_model: int, *, generator, device,
                   dtype=torch.float32) -> Params:
    return {"embedding": _normal((vocab, d_model), dtype, 1.0, generator,
                                 device)}


class _Lookup(torch.autograd.Function):
    """``table[tokens]``; backward: each row's gradients summed in fp32
    (one ``index_put_`` with accumulate into an fp32 table: deterministic)
    and cast to the table's dtype once.  Indexing's own backward adds
    each occurrence into the table's dtype, so in bf16 the row of a token
    that occurs a few hundred times in a batch (a Zipf stream's first
    tokens) drifts by a few percent, and by another few where the batch
    is split over ranks."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        acc_dtype = (torch.float32 if ctx.dtype in (torch.bfloat16,
                                                    torch.float16)
                     else ctx.dtype)
        acc = torch.zeros(ctx.shape, dtype=acc_dtype, device=g.device)
        acc.index_put_((tokens.reshape(-1),),
                       g.reshape(-1, g.shape[-1]).to(acc_dtype),
                       accumulate=True)
        return acc.to(ctx.dtype), None


def embed(p: Params, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """Row lookup times sqrt(d_model), in the table's dtype; the table's
    gradient summed in fp32 (``_Lookup``)."""
    return _Lookup.apply(p["embedding"], tokens) * (d_model ** 0.5)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied head: logits = x @ E^T, returned in fp32."""
    return torch.einsum("bsd,vd->bsv", x, p["embedding"]).to(torch.float32)

"""Plain PyTorch versions of every kernel (allclose targets in tests and in
``chip_smoke.py``).  Straightforward math, no tiling: they say WHAT the
kernels compute, in the same layouts as the port's kernel wrappers."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale over the last axis, in fp32,
    cast back to x.dtype.  x: (..., D); scale: (D,)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,Hkv,D) with Hkv | H — q head h reads kv
    head h // (H // Hkv).  fp32 softmax over dense logits; the causal mask
    is top-left aligned (query i sees keys 0..i, both counted from 0, also
    when S != T) with the finite mask value -1e30.  Returns q.dtype."""
    H, Hkv = q.shape[2], k.shape[2]
    S, T = q.shape[1], k.shape[1]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    if causal:
        qp = torch.arange(S, device=q.device)
        kp = torch.arange(T, device=q.device)
        logits = logits.masked_fill(~(qp[:, None] >= kp[None, :]), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs, vf).to(q.dtype)

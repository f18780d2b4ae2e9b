"""Model-layout adapters over the port's kernels (twin of
``repro/kernels/ops.py``).

The model passes (B, S, H, D) tensors.  The flash kernel wants head-major
(B, H, S, D): the adapter hands it transposed *views* (the kernel takes
strides), so no layout copy happens, and GQA kv stays at Hkv heads — the
kernel maps q head h to kv head h // (H / Hkv), the same mapping as the
reference's ``jnp.repeat`` over the kv head axis.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,Hkv,D) with Hkv | H -> (B,S,H,D)."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=scale, causal=causal)
    return out.transpose(1, 2)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) -> x.dtype."""
    return _rn.rmsnorm(x, scale, eps)

"""Model-layout adapters over the port's kernels (twin of
``repro/kernels/ops.py``).

On CUDA all three are differentiable: each runs as a
``torch.autograd.Function`` whose backward is a hand-written kernel
(``csrc/flash_attention_bwd.cu``, the backward in ``csrc/rmsnorm.cu``,
``csrc/ssd_scan_bwd.cu``) whenever autograd needs it; the adapters below
hand the gradients through unchanged.  On the CPU all three run their
plain versions, which autograd differentiates.

The model passes (B, S, H, D) tensors.  The flash kernel wants head-major
(B, H, S, D): the adapter hands it transposed *views* (the kernel takes
strides), so no layout copy happens.  GQA kv stays at Hkv heads — the flash
kernel maps q head h to kv head h // (H / Hkv), the same mapping as the
reference's ``jnp.repeat`` over the kv head axis.  The SSD scan takes the
model's layout as it is; its B and C stay at G groups, read by head h as
group h // (H / G), where the reference copies them out to every head.

Each adapter hands its call to the kernel accounting hook when one is
installed (``kernel_hook``; ``analysis/ircost.py`` installs one): the
hook gets the kernel's name, the wrapper and the call's arguments, and
returns what the wrapper returns.  Without a hook the wrapper is called
directly.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd

_hook = None


@contextlib.contextmanager
def kernel_hook(hook):
    """Install ``hook(name, wrapper, args, kwargs)`` -> the wrapper's
    result for every kernel call inside the block (the one before it is
    restored after)."""
    global _hook
    prev, _hook = _hook, hook
    try:
        yield
    finally:
        _hook = prev


def _call(name, fn, *args, **kwargs):
    if _hook is None:
        return fn(*args, **kwargs)
    return _hook(name, fn, args, kwargs)


def _flash(q, k, v, *, scale, causal):
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=scale, causal=causal)
    return out.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,Hkv,D) with Hkv | H -> (B,S,H,D)."""
    return _call("flash_attention", _flash, q, k, v, scale=scale,
                 causal=causal)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,) -> x.dtype."""
    return _call("rmsnorm", _rn.rmsnorm, x, scale, eps)


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                  *, d_total: int, group=None) -> torch.Tensor:
    """x: (..., D) this rank's columns of rows of ``d_total`` split over
    ``group``; scale: (D,) -> x.dtype."""
    return _call("rmsnorm_split", _rn.rmsnorm_split, x, scale, eps,
                 d_total=d_total, group=group)


def ssd_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor,
             h0: torch.Tensor | None = None, *,
             chunk: int = _ssd.DEFAULT_CHUNK):
    """The kernel takes the model's layout itself: x (B,S,H,P); Bm, Cm
    (B,S,G,N); dt, a (B,S,H) float32; h0 (B,H,P,N) float32 or None ->
    (y (B,S,H,P) float32, h_final (B,H,P,N) float32)."""
    return _call("ssd_scan", _ssd.ssd_scan, x, Bm, Cm, dt, a, h0,
                 chunk=chunk)

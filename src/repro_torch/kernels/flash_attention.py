"""Flash attention forward — hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` (``_flash_kernel``) with the same semantics: online
softmax with fp32 m, l and accumulator; top-left causal mask; tiles above
the diagonal skipped; padded keys masked in the kernel; finite -1e30 mask;
denominator clamped at 1e-30.  Unlike the TPU wrapper it takes GQA kv
(fewer kv heads than q heads) directly and reads kv head h // (H/Hkv).

Bound on an H100: operations, 4*B*H*D*(unmasked pairs) at 989 TFLOP/s
bf16.  bf16 runs on the tensor cores (the source header has the design):
blocks of 128 q rows as two consumer warpgroups, kv tiles of 64 keys
brought by a TMA producer warpgroup into a four-stage mbarrier ring,
QK^T and PV as ``wgmma`` from swizzled bf16 shared memory, softmax in
registers, and P split into bf16 hi + lo so that PV keeps P to about 16
bits, as the fp32 specification needs.  fp32 runs on an fp32 FMA body.
bf16 needs every row start 16-byte aligned (strides multiples of 8
elements), which the model's layouts give.

``flash_attention(q, k, v)`` launches the kernel for CUDA tensors and
raises on anything the kernel does not take; for CPU tensors it runs the
plain version, ``ref.flash_attention_ref``.  It never falls back from one
to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def bind(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_flash_attention`` entry point)."""
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _entry():
    global _fn
    if _fn is None:
        _fn = bind(build.load("flash_attention"))
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,D); k,v: (B,Hkv,T,D) with Hkv | H.  Any strides with the
    last axis contiguous (the ops adapter passes transposed views of the
    model's (B,S,H,D) tensors, so nothing is copied).  Returns (B,H,S,D)
    in q.dtype, laid out like q."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), scale=scale,
                                  causal=causal)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype} must match and be float32 or bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: H={H} not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head-dim axis must be "
                         "contiguous")
    o = torch.empty_like(q)            # keeps q's strides (dense layouts)
    if o.stride(-1) != 1:
        o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in t.stride()[:3])
            for t in (q, k, v, o)):
        raise ValueError("flash_attention: bf16 rows must start 16-byte "
                         "aligned (pointers and strides)")
    if S == 0 or B == 0:
        return o
    if T == 0:
        raise ValueError("flash_attention: no keys (T=0)")
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              B, H, Hkv, S, T, D,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              o.stride(0), o.stride(1), o.stride(2),
              scale, int(causal), _DTYPES[q.dtype], stream)
    build.check(lib, code, "flash_attention launch")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

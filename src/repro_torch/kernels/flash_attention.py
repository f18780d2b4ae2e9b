"""Flash attention, forward and backward — hand-written CUDA kernels for
Hopper (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).

The forward replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` (``_flash_kernel``) with the same semantics: online
softmax with fp32 m, l and accumulator; top-left causal mask; tiles above
the diagonal skipped; padded keys masked in the kernel; finite -1e30 mask;
denominator clamped at 1e-30.  Unlike the TPU wrapper it takes GQA kv
(fewer kv heads than q heads) directly and reads kv head h // (H/Hkv).

Head dims: every D in ``HEAD_DIMS`` (16, 32, 64, 128, 160, 256), in fp32
and bf16, forward and backward.  Bound on an H100: operations,
4*B*H*D*(unmasked pairs) forward at 989 TFLOP/s bf16 (at the model's
shapes often the bytes, q, k, v and o once each at 3.35 TB/s).  bf16
runs on the tensor cores at every D (``FWD_TENSOR_CORE_DIMS``; the
source header has the design): blocks of 128 q rows as two consumer
warpgroups, kv tiles of 64 keys brought by a TMA producer warpgroup into
an mbarrier ring (four stages, two at D = 256: 192 KB of shared memory),
QK^T and PV as ``wgmma`` from swizzled bf16 shared memory (64-byte
swizzle blocks of 32 columns at D = 160), softmax in registers, and P
split into bf16 hi + lo so that PV keeps P to about 16 bits, as the fp32
specification needs.  fp32 at D <= 128 (``TF32_DIMS``) runs on the tensor
cores too, as ``mma.sync`` m16n8k8 with every fp32 operand split into
TF32 big + small and each product taken as three TF32 products (about 20
significant bits: within a few 1e-6 of the fp32 plain version, where one
TF32 pass would miss the fp32 check by 20x), in tiles cut to the sequence:
16 q rows a warp, keys in tiles of 80 (S = T = 65 computes 80 x 80
scores, not 128 x 128).  Both tensor-core routes need every row start
16-byte aligned (strides multiples of 8 bf16 or 4 fp32 elements), which
the model's layouts give, and raise otherwise.  fp32 at D = 160 and 256 runs on an
fp32 FMA body.

The backward (the reference has none: it trains through plain attention)
recomputes P from the forward's row logsumexp.  bf16 at D <= 160
(``BWD_TENSOR_CORE_DIMS``) runs on the tensor cores (the source header
has the design): a pre-pass for Di and lse in log2 units; a dK/dV kernel
whose clusters of two blocks split each 64-key tile's (q head, q tile)
items, over four consumer warpgroups at D <= 128 (S^T, dP^T, dV and dK as
``wgmma``, P^T and dS^T rounded once to bf16), and at D = 160 over the
two blocks with each block's two warpgroups split by product (one forms
P^T and sums dV, the other dS^T and dK); the sums meet in a fixed order;
a dQ kernel that mirrors the forward.  fp32 at D <= 128 runs split-TF32
tensor-core kernels: where a (b, kv head)'s keys fit one block (T <= 208,
64 at D = 128) one launch holds them resident, 16 keys a warp, walks the
group's q steps, forms Di, S^T and dP^T once and finishes dK, dV and each
dQ step in place (five products); past that, key tiles of up to 96 keys
sum dK and dV and a second kernel forms dQ by q rows.  fp32 at D = 160
and 256, and bf16 at D = 256, run fp32 FMA kernels.  No float atomics:
every call gives the same bits.

``flash_attention(q, k, v)`` launches the forward for CUDA tensors and
raises on anything the kernels do not take; when autograd needs its
gradient (grad mode on and an input that requires grad) it runs as
``FlashAttentionFn``, whose backward is the backward kernel.  For CPU
tensors it runs the plain version, ``ref.flash_attention_ref``, which
autograd differentiates.  It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

# the head dims both sources are built for (csrc/flash_attention.cu and
# csrc/flash_attention_bwd.cu: dispatch_d); bf16 takes the tensor-core
# bodies (dispatch_tc) at these, the backward's FMA body at D = 256
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
FWD_TENSOR_CORE_DIMS = HEAD_DIMS
BWD_TENSOR_CORE_DIMS = (16, 32, 64, 128, 160)
# fp32 takes the split-TF32 bodies (dispatch_tf32) at these, forward and
# backward, and the FMA bodies at the rest
TF32_DIMS = (16, 32, 64, 128)
# the backward's scratch holds two fp32 (B, H, Sp) arrays, Sp = S rounded
# up to this (csrc/flash_attention_bwd.cu: kRowAlign)
BWD_ROW_ALIGN = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None


def bind(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_flash_attention`` entry point)."""
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def bind_bwd(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_flash_attention_bwd`` entry point)."""
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _entry():
    global _fn
    if _fn is None:
        _fn = bind(build.load("flash_attention"))
    return _fn


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = bind_bwd(build.load("flash_attention_bwd"))
    return _bwd_fn


def _bhs(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor laid out like ``t`` (its strides, for a dense
    layout), with the last axis contiguous."""
    out = torch.empty_like(t)
    if out.stride(-1) != 1:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    B, H, S, D = q.shape
    Hkv = k.shape[1]
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


def _aligned(*ts: torch.Tensor) -> bool:
    """Every row start 16-byte aligned (pointer and strides), as TMA and
    cp.async read the tensor-core bodies' tiles."""
    return all(t.data_ptr() % 16 == 0
               and all(x % (16 // t.element_size()) == 0
                       for x in t.stride()[:3])
               for t in ts)


def _tensor_cores(q: torch.Tensor, dims: tuple) -> bool:
    """Whether ``q``'s dtype and head dim take a tensor-core body: bf16 at
    ``dims`` (the bf16 bodies' head dims), fp32 at ``TF32_DIMS``."""
    if q.dtype == torch.float32:
        return q.shape[3] in TF32_DIMS
    return q.dtype == torch.bfloat16 and q.shape[3] in dims


def _forward(q, k, v, scale: float, causal: bool, with_lse: bool):
    """Launch the forward kernel -> (o laid out like q, the rows'
    logsumexp (B, H, S) fp32 or None)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    o = _like(q)
    if _tensor_cores(q, FWD_TENSOR_CORE_DIMS) and not _aligned(q, k, v, o):
        raise ValueError(f"flash_attention: {q.dtype} rows at D={D} must "
                         "start 16-byte aligned (pointers and strides)")
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if S == 0 or B == 0:
        return o, lse
    if T == 0:
        raise ValueError("flash_attention: no keys (T=0)")
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              None if lse is None else lse.data_ptr(),
              B, H, Hkv, S, T, D, *_bhs(q), *_bhs(k), *_bhs(v), *_bhs(o),
              scale, int(causal), _DTYPES[q.dtype], stream)
    build.check(lib, code, "flash_attention launch")
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool):
    """The backward kernels (pre-pass, dK/dV, dQ): q, o, do (B,H,S,D);
    k, v (B,Hkv,T,D); lse the forward's (B,H,S) fp32 logsumexp.  Any
    strides with the last axis contiguous.  -> (dq, dk, dv), each laid out
    like its input."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if do.stride(-1) != 1:
        do = do.contiguous()
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} "
                         f"/ do {tuple(do.shape)} {do.dtype} do not match q")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S)
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be contiguous "
                         f"float32 {(B, H, S)}")
    dq, dk, dv = _like(q), _like(k), _like(v)
    if S == 0 or B == 0:
        return dq, dk.zero_(), dv.zero_()
    if _tensor_cores(q, BWD_TENSOR_CORE_DIMS):
        if not _aligned(do):
            do = do.contiguous()
        if not _aligned(q, k, v, o, do, dq, dk, dv):
            raise ValueError(f"flash_attention_bwd: {q.dtype} rows at "
                             f"D={D} must start 16-byte aligned (pointers "
                             "and strides)")
    rows = -(-S // BWD_ROW_ALIGN) * BWD_ROW_ALIGN
    scratch = torch.empty(2 * B * H * rows, dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in _bhs(t)))
    lib, fn = _bwd_entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), B, H, Hkv, S, T, D, strides,
              scale, int(causal), _DTYPES[q.dtype], stream)
    build.check(lib, code, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = _forward(q, k, v, scale, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,D); k,v: (B,Hkv,T,D) with Hkv | H and D in ``HEAD_DIMS``.
    Any strides with the last axis contiguous (the ops adapter passes
    transposed views of the model's (B,S,H,D) tensors, so nothing is
    copied).  Returns (B,H,S,D) in q.dtype, laid out like q;
    differentiable on CUDA through the backward kernel."""
    D = q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), scale=scale,
                                  causal=causal)
        return out.transpose(1, 2)
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, scale, causal)
    return _forward(q, k, v, scale, causal, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0

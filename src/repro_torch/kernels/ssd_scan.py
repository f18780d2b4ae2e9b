"""Mamba2 SSD chunked scan — hand-written CUDA kernel for Hopper
(``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:ssd_scan``
(``_ssd_kernel``) with the same semantics: chunks of Q = min(chunk, S)
rows, the ragged tail padded with dt = a = 0, the causal mask a select (so
an ``exp`` that overflows above the diagonal never meets a 0), the state
carried in fp32 across chunks from ``h0`` to ``h_final``.  Unlike the TPU
wrapper it takes B and C per group and reads group h // (H/G) for head h,
and it takes every input in the model's (B,S,H,...) layout by strides, so
nothing is copied, transposed or expanded.

bf16 inputs run three CUDA kernels a call on the tensor cores (chunk
states in parallel, the state passed across chunks, then y in parallel;
the source's header has the design) with a chunk-state scratch this
wrapper allocates; fp32 inputs run the FMA kernel.  Bound on an H100 at
the path's shapes: bytes (see the source's header).

The backward (the reference defines none: it trains through the plain
jnp scan, ``repro/models/mamba2.py::_ssd_chunked``) is the gradient of
the same function, four CUDA kernels a call in ``csrc/ssd_scan_bwd.cu``
(the source's header has the algebra): the chunk states again and the
dy·C sums in parallel, the two serial passes over the chunks (states
forward from h0, their gradients back from dh_final), every gradient of
a chunk in parallel, and dB, dC summed over each group's heads.  bf16
runs the tensor-core body: its gradient kernel takes a slice of a
group's heads a block, C·Bᵀ once, and dB, dC summed over the slice in
registers, then the slices' partials summed in slice order.  fp32 runs
the FMA body (per-head dB, dC summed in head order).  No atomics: two
calls give the same bits.  The states are recomputed, not kept from the
forward.

``ssd_scan(...)`` launches the forward kernels for CUDA tensors and raises
on anything they do not take; when autograd needs its gradient (grad mode
on and an input that requires grad) it runs as ``SSDScanFn``, whose
backward is ``ssd_scan_bwd``.  For CPU tensors it runs the plain version,
``ref.ssd_scan_ref``, which autograd differentiates.  It never falls back
from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_scan_ref

DEFAULT_CHUNK = 128
MAX_Q = 128              # chunk rows the kernel takes
MAX_N = 128              # d_state
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fn = None


def bind(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_ssd_scan`` entry point)."""
    fn = lib.repro_ssd_scan
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 18
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def bind_bwd(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_ssd_scan_bwd`` entry point); the
    library's ``repro_ssd_scan_bwd_scratch`` (floats of scratch a call
    needs) is typed too."""
    fn = lib.repro_ssd_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_ssd_scan_bwd_scratch.argtypes = [ctypes.c_int] * 8
    lib.repro_ssd_scan_bwd_scratch.restype = ctypes.c_longlong
    return lib, fn


def _entry():
    global _fn
    if _fn is None:
        _fn = bind(build.load("ssd_scan"))
    return _fn


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = bind_bwd(build.load("ssd_scan_bwd"))
    return _bwd_fn


def _bhs(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides over (batch, head or group, row) of a (B,S,H,...)
    tensor, the order the kernel takes them in."""
    return t.stride(0), t.stride(2), t.stride(1)


def _check(x, Bm, Cm, dt, a, h0, chunk) -> int:
    """Raise on anything the kernels do not take; -> Q."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: x/Bm/Cm dtypes {x.dtype}/{Bm.dtype}/"
                         f"{Cm.dtype} must match and be float32 or bfloat16")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt/a dtypes {dt.dtype}/{a.dtype} must "
                         f"be float32")
    tensors = (x, Bm, Cm, dt, a) + (() if h0 is None else (h0,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: inputs on different devices")
    if Bm.shape != Cm.shape or Bm.shape[0] != B or Bm.shape[1] != S:
        raise ValueError(f"ssd_scan: Bm {tuple(Bm.shape)} / Cm "
                         f"{tuple(Cm.shape)} do not match x {tuple(x.shape)}")
    if tuple(dt.shape) != (B, S, H) or tuple(a.shape) != (B, S, H):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} / a "
                         f"{tuple(a.shape)} must be {(B, S, H)}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: H={H} not a multiple of G={G}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"ssd_scan: d_state N={N} outside [1, {MAX_N}]")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
    Q = min(chunk, S)
    if Q > MAX_Q:
        raise ValueError(f"ssd_scan: chunk of {Q} rows > {MAX_Q}")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("ssd_scan: the last axis of x, Bm and Cm must be "
                         "contiguous")
    if h0 is not None and (h0.dtype != torch.float32 or not
                           h0.is_contiguous() or
                           tuple(h0.shape) != (B, H, P, N)):
        raise ValueError(f"ssd_scan: h0 must be contiguous float32 "
                         f"{(B, H, P, N)}, got {h0.dtype} "
                         f"{tuple(h0.shape)}")
    return Q


def _forward(x, Bm, Cm, dt, a, h0, Q):
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    hf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # bf16: the chunk states (B, H, nc, P, N) and each chunk's cum_last
    nc = -(-S // Q)
    scratch = (torch.empty(B * H * nc * (P * N + 1), dtype=torch.float32,
                           device=x.device)
               if x.dtype == torch.bfloat16 else None)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
              a.data_ptr(), None if h0 is None else h0.data_ptr(),
              y.data_ptr(), hf.data_ptr(),
              None if scratch is None else scratch.data_ptr(),
              B, H, G, S, P, N, Q,
              *_bhs(x), *_bhs(Bm), *_bhs(Cm), *_bhs(dt), *_bhs(a), *_bhs(y),
              _DTYPES[x.dtype], stream)
    build.check(lib, code, "ssd_scan launch")
    ssd_scan.launches += 1
    return y, hf


def ssd_scan_bwd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
                 dy: torch.Tensor, dh_final: torch.Tensor | None = None, *,
                 chunk: int = DEFAULT_CHUNK):
    """The backward kernel: the gradients of ``ssd_scan``'s (y, h_final)
    w.r.t. its inputs, given dy (B,S,H,P) and dh_final (B,H,P,N) or None
    (no gradient).  Inputs as ``ssd_scan`` takes them, on CUDA.  Returns
    (dx, dBm, dCm) in x's dtype, (ddt, da) float32, and dh0 (B,H,P,N)
    float32 (None when h0 is None), each a fresh contiguous tensor of its
    input's shape."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {x.device}")
    Q = _check(x, Bm, Cm, dt, a, h0, chunk)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dy.shape) != (B, S, H, P) or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} must be {(B, S, H, P)} on {x.device}")
    if dh_final is not None and (tuple(dh_final.shape) != (B, H, P, N) or
                                 dh_final.device != x.device):
        raise ValueError(f"ssd_scan_bwd: dh_final {tuple(dh_final.shape)} "
                         f"on {dh_final.device} must be {(B, H, P, N)} on "
                         f"{x.device}")
    dy = dy.float().contiguous()
    if dh_final is not None:
        dh_final = dh_final.float().contiguous()
    dev = x.device
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    dBm = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    dCm = torch.empty((B, S, G, N), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    da = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dh0 = (torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
           if h0 is not None else None)
    # the chunk states, cum_last, and the dB / dC partials: the source's
    # repro_ssd_scan_bwd_scratch has the layout
    lib, fn = _bwd_entry()
    scratch = torch.empty(lib.repro_ssd_scan_bwd_scratch(
        B, H, G, S, P, N, Q, _DTYPES[x.dtype]), dtype=torch.float32,
        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    code = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
              a.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh_final),
              dx.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), ddt.data_ptr(),
              da.data_ptr(), ptr(dh0), scratch.data_ptr(),
              B, H, G, S, P, N, Q,
              *_bhs(x), *_bhs(Bm), *_bhs(Cm), *_bhs(dt), *_bhs(a),
              _DTYPES[x.dtype], stream)
    build.check(lib, code, "ssd_scan_bwd launch")
    ssd_scan_bwd.launches += 1
    return dx, dBm, dCm, ddt, da, dh0


class SSDScanFn(torch.autograd.Function):
    """The forward kernels, with the backward kernel as their gradient."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, a, h0, Q: int):
        ctx.save_for_backward(x, Bm, Cm, dt, a, h0)
        ctx.Q = Q
        ctx.set_materialize_grads(False)
        return _forward(x, Bm, Cm, dt, a, h0, Q)

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, Bm, Cm, dt, a, h0 = ctx.saved_tensors
        if dy is None:                       # only h_final was used
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, dBm, dCm, ddt, da, dh0 = ssd_scan_bwd(
            x, Bm, Cm, dt, a, h0, dy, dh_final, chunk=ctx.Q)
        return dx, dBm, dCm, ddt, da, dh0, None


def ssd_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor,
             h0: torch.Tensor | None = None, *,
             chunk: int = DEFAULT_CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """The model's layout: x (B,S,H,P); Bm, Cm (B,S,G,N) with G | H; dt, a
    (B,S,H) float32; h0 (B,H,P,N) float32 or None (zeros).  Any strides,
    with the last axis of x, Bm and Cm contiguous.  x, Bm and Cm share
    float32 or bfloat16.  Returns y (B,S,H,P) float32 and h_final
    (B,H,P,N) float32; differentiable on CUDA through the backward
    kernel."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, Bm, Cm, dt, a, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    Q = _check(x, Bm, Cm, dt, a, h0, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, Bm, Cm, dt, a, h0)):
        return SSDScanFn.apply(x, Bm, Cm, dt, a, h0, Q)
    return _forward(x, Bm, Cm, dt, a, h0, Q)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0

"""Fused RMSNorm, forward and backward — hand-written CUDA kernels for
Hopper (``csrc/rmsnorm.cu``).

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py:rmsnorm``
(``_rmsnorm_kernel``).  Bound on an H100: bytes — each element is read
once and written once at 3.35 TB/s; the kernel keeps a row in registers
between the sum of squares and the write, so it moves nothing twice.

Each row gets a group of lanes, each lane a few vectors of 16 bytes, all
loaded before any arithmetic; a block holds several rows
(``launch_shape`` picks the shape, the source's header says why).  This
register-held body takes rows of up to 16,384 elements in 16-byte vectors
and 8,192 in single elements (``max_register_d``); wider rows, as the
reference's whole-row blocks take them, walk a looped body: a block of
1,024 threads a row, which reads the row twice (the second time from L2).
Every D >= 1 is taken.

The backward (the reference defines none; this is the gradient of the
same function) keeps the lane groups with at most 4 vectors a lane
(``bwd_launch_shape``): dx = r*(g*s - xh*mean(g*s*xh)) per row, on a grid
of one block an SM whose blocks walk their rows (a looped twin for rows
past ``max_register_d``); dscale = sum over rows of g*xh, one partial row
a block, then summed over the card in a fixed order, so it is the same on
every run.

A row split over ranks (``rmsnorm_split``: mamba2's gated norm over a
d_inner whose heads lie over `model`) takes the same bodies in two
launches a direction: each row's sums over this rank's columns, an
all-reduce of them over the group, then the rest of the body over the
whole row's width (the source's header says how), in every dtype pair
the whole-row kernel takes.

``rmsnorm(x, scale)`` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; when autograd needs its gradient (grad
mode on and an input that requires grad) it runs as ``RMSNormFn``, whose
backward is the backward kernel.  For a CPU tensor it runs the plain
version, ``ref.rmsnorm_ref``, which autograd differentiates.  It never
falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref, rmsnorm_split_ref

VEC_BYTES = 16             # one vector load
MAX_VECS_PER_LANE = 8      # csrc/rmsnorm.cu: kMaxNV
MIN_BLOCK = 256            # csrc/rmsnorm.cu: kMinBlock
LANE_GROUPS = (8, 16, 32, 64, 128, 256, 512, 1024)   # csrc/rmsnorm.cu builds
# elements a vector group spans at most (lanes x elements a vector), in the
# forward and the backward (csrc/rmsnorm.cu: kMaxVecSpan, kMaxVecSpanBwd)
MAX_VEC_SPAN = 2048
BWD_MAX_VEC_SPAN = 4096
# the backward's 16-byte vectors a lane (csrc/rmsnorm.cu: max_nv_bwd; 8
# single elements)
BWD_MAX_VECS_PER_LANE = 4
# threads a row (and a block) of the looped bodies (csrc/rmsnorm.cu:
# kLoopLanes)
LOOP_LANES = 1024
# the backward's grid: at most one block an SM of an H100 (132), each
# walking its rows with the grid's stride; each writes one row of dscale
# partials
BWD_MAX_BLOCKS = 132
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the split row's two launches (csrc/rmsnorm.cu: kSumSq, kApply)
SUM_SQ, APPLY = 1, 2
_fn = None
_bwd_fn = None
_split_fn = None
_split_bwd_fn = None


def launch_shape(D: int, itemsize: int, aligned: bool = True):
    """The kernel's launch shape for rows of ``D`` elements of
    ``itemsize`` bytes -> ``(lanes per row, vectors per lane, rows per
    block, elements per vector)``.  Vectors are 16 bytes when D is a
    multiple of their width and the pointers are 16-byte ``aligned``, else
    single elements.  The group is the narrowest that holds the row in at
    most 8 vectors a lane, so a lane has several loads in flight; a block
    has ``max(256, lanes)`` threads."""
    return _shape(D, itemsize, aligned, backward=False)


def bwd_launch_shape(D: int, itemsize: int, aligned: bool = True):
    """The backward kernel's launch shape, as ``launch_shape`` but with at
    most ``BWD_MAX_VECS_PER_LANE`` 16-byte vectors a lane (8 single
    elements), so that a block of ``max(MIN_BLOCK, lanes)`` threads keeps
    its registers under 128 a thread."""
    return _shape(D, itemsize, aligned, backward=True)


def max_register_d(vec: int, backward: bool = False) -> int:
    """The widest row the register-held body takes in vectors of ``vec``
    elements (csrc/rmsnorm.cu: max_register_d): 16,384 in 16-byte
    vectors, 8,192 in single elements.  Wider rows take the looped body,
    whose launch shape is ``(LOOP_LANES, vectors a thread, 1, vec)``."""
    if vec == 1:
        return LANE_GROUPS[-1] * MAX_VECS_PER_LANE
    if backward:
        return BWD_MAX_VEC_SPAN * BWD_MAX_VECS_PER_LANE
    return MAX_VEC_SPAN * MAX_VECS_PER_LANE


def _shape(D: int, itemsize: int, aligned: bool, backward: bool):
    if D < 1:
        raise ValueError(f"rmsnorm: D={D} must be at least 1")
    vec = VEC_BYTES // itemsize
    if D % vec or not aligned:
        vec = 1
    nvec = D // vec
    if D > max_register_d(vec, backward):
        return LOOP_LANES, -(-nvec // LOOP_LANES), 1, vec
    max_vecs = (BWD_MAX_VECS_PER_LANE if backward and vec > 1
                else MAX_VECS_PER_LANE)
    lanes = next(g for g in LANE_GROUPS if g * max_vecs >= nvec)
    return lanes, -(-nvec // lanes), max(MIN_BLOCK, lanes) // lanes, vec


def bwd_blocks(rows: int, rows_per_block: int) -> int:
    """Blocks of the backward's grid: one per group of ``rows_per_block``
    rows, at most ``BWD_MAX_BLOCKS`` (a function of the shape alone, so
    the order in which dscale is summed is too)."""
    return max(1, min(-(-rows // rows_per_block), BWD_MAX_BLOCKS))


def _entry():
    global _fn
    if _fn is None:
        _fn = bind(build.load("rmsnorm"))
    return _fn


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        _bwd_fn = bind_bwd(build.load("rmsnorm"))
    return _bwd_fn


def _split_entries():
    global _split_fn, _split_bwd_fn
    if _split_fn is None:
        lib = build.load("rmsnorm")
        _split_fn, _split_bwd_fn = bind_split(lib), bind_split_bwd(lib)
    return _split_fn, _split_bwd_fn


def bind_split(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_rmsnorm_split`` entry point)."""
    fn = lib.repro_rmsnorm_split
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bind_split_bwd(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_rmsnorm_split_bwd`` entry point)."""
    fn = lib.repro_rmsnorm_split_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bind(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_rmsnorm`` entry point)."""
    fn = lib.repro_rmsnorm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def bind_bwd(lib: ctypes.CDLL):
    """-> (lib, its typed ``repro_rmsnorm_bwd`` entry point)."""
    fn = lib.repro_rmsnorm_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}/{scale.dtype} not "
                         f"supported (float32, bfloat16)")
    if scale.device != x.device or tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm: scale must be ({D},) on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if D < 1:
        raise ValueError(f"rmsnorm: D={D} must be at least 1")


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float):
    D = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, scale, y))
    lanes, per_lane, rows_per_block, vec = launch_shape(
        D, x.element_size(), aligned)
    lib, fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, D,
              _DTYPES[x.dtype], _DTYPES[scale.dtype], eps, lanes, per_lane,
              rows_per_block, vec, stream)
    build.check(lib, code, "rmsnorm launch")
    rmsnorm.launches += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels: x and g (the gradient of y) (..., D) in x's
    dtype, scale (D,) -> (dx in x.dtype, dscale in scale.dtype)."""
    _check(x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: g {tuple(g.shape)} {g.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    g = g.contiguous()
    D = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, scale, g, dx))
    lanes, per_lane, rows_per_block, vec = bwd_launch_shape(
        D, x.element_size(), aligned)
    blocks = bwd_blocks(rows, rows_per_block)
    partial = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    lib, fn = _bwd_entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
              partial.data_ptr(), dscale.data_ptr(), rows, D,
              _DTYPES[x.dtype], _DTYPES[scale.dtype], eps, lanes, per_lane,
              rows_per_block, vec, blocks, stream)
    build.check(lib, code, "rmsnorm_bwd launch")
    rmsnorm_bwd.launches += 1
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) contiguous, float32 or bfloat16; scale: (D,), float32 or
    bfloat16.  Returns x.dtype; differentiable on CUDA through the
    backward kernel."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    return _forward(x, scale, eps)


def _sum_over(t: torch.Tensor, group) -> None:
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=group)


def _check_split(x: torch.Tensor, scale: torch.Tensor, d_total: int,
                 group) -> None:
    _check(x, scale)
    if d_total < x.shape[-1] or (group is None and d_total != x.shape[-1]):
        raise ValueError(f"rmsnorm_split: d_total={d_total} for a slice of "
                         f"{x.shape[-1]} columns"
                         f"{'' if group is not None else ' without a group'}")


def _split_forward(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   d_total: int, group) -> torch.Tensor:
    """The forward's two launches around the all-reduce (as
    ``_split_backward``)."""
    D = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    sums = torch.empty((rows,), dtype=torch.float32, device=x.device)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, scale, y))
    lanes, per_lane, rows_per_block, vec = launch_shape(
        D, x.element_size(), aligned)
    (lib, fn), _ = _split_entries()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for split in (SUM_SQ, APPLY):
        code = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                  sums.data_ptr(), rows, D, d_total, split,
                  _DTYPES[x.dtype], _DTYPES[scale.dtype], eps, lanes,
                  per_lane, rows_per_block, vec, stream)
        build.check(lib, code, "rmsnorm_split launch")
        if split == SUM_SQ:
            _sum_over(sums, group)
    rmsnorm_split.launches += 1
    return y


def rmsnorm_split_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-6, *, d_total: int,
                      group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The split row's backward: x and g (..., D) this rank's columns,
    scale (D,) -> (dx, this rank's dscale).  Each row's sum(x^2) and
    sum(g * scale * x) over these columns, all-reduced over ``group``,
    then dx and dscale from them."""
    _check_split(x, scale, d_total, group)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rmsnorm_split_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    return _split_backward(x, scale, g.contiguous(), eps, d_total, group)


def _split_backward(x, scale, g, eps, d_total, group):
    """The backward's two launches around the all-reduce (none without a
    group: then d_total may exceed D, the other columns' sums taken as 0,
    which is how a single card times the launches)."""
    D = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    sums = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, scale, g, dx))
    lanes, per_lane, rows_per_block, vec = bwd_launch_shape(
        D, x.element_size(), aligned)
    blocks = bwd_blocks(rows, rows_per_block)
    partial = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    _, (lib, fn) = _split_entries()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for split in (SUM_SQ, APPLY):
        code = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                  dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                  sums.data_ptr(), rows, D, d_total, split,
                  _DTYPES[x.dtype], _DTYPES[scale.dtype], eps, lanes,
                  per_lane, rows_per_block, vec, blocks, stream)
        build.check(lib, code, "rmsnorm_split_bwd launch")
        if split == SUM_SQ:
            _sum_over(sums, group)
    rmsnorm_split_bwd.launches += 1
    return dx, dscale


class RMSNormSplitFn(torch.autograd.Function):
    """The split row's forward kernels, with its backward kernels as the
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps: float, d_total: int, group):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.d_total, ctx.group = eps, d_total, group
        return _split_forward(x, scale, eps, d_total, group)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_split_bwd(x, scale, g, ctx.eps,
                                       d_total=ctx.d_total, group=ctx.group)
        return dx, dscale, None, None, None


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                  *, d_total: int, group=None) -> torch.Tensor:
    """RMSNorm of rows split over the ranks of ``group``: x (..., D)
    contiguous and scale (D,) are this rank's D of each row's ``d_total``
    columns (every rank of the group calls it, on the same rows); returns
    this rank's columns of y in x.dtype.  Without a group the row is whole
    (d_total = D), and the result is ``rmsnorm``'s bit for bit.  The plain
    version, ``ref.rmsnorm_split_ref``, for a CPU tensor; on CUDA the
    kernels, differentiable through their backward."""
    if x.device.type == "cpu":
        return rmsnorm_split_ref(x, scale, eps, d_total=d_total, group=group)
    _check_split(x, scale, d_total, group)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormSplitFn.apply(x, scale, eps, d_total, group)
    return _split_forward(x, scale, eps, d_total, group)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
rmsnorm_split.launches = 0
rmsnorm_split_bwd.launches = 0

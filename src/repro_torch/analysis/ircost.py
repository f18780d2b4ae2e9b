"""Step facts for the paged serving steps (twin of
``repro/analysis/ircost.py``).

The tracecheck analyzers' extraction half.  The reference lowers each
jitted serving step (make_paged_prefill_step / make_paged_decode_step /
make_slot_admit_step) against ShapeDtypeStructs and reads XLA's facts.
The port runs eagerly, so here "lowering" is running the step ONCE, at
exactly the engine's call shapes, under recorders (``TracedStep``):

  * a ``TorchDispatchMode`` that sees every aten op the step dispatches:
    its name (``op_census``), its FLOPs (FlopCounterMode's formulas), the
    bytes of its tensor inputs and outputs unless it is a view
    (``cost_report``), the intermediates it leaves alive (the CPU's
    ``temp_bytes``), any op that reads a pool leaf and writes a new
    tensor at least as large (a pool copy, ``donation_report``), and
    every host sync: ``aten._local_scalar_dense``, a device-to-host copy,
    and on CUDA any op that ``torch.cuda.set_sync_debug_mode("error")``
    stops (``host_syncs``).  Host-to-device copies of the step's host
    arrays (the sampler's rows, an admission's frontend) are the step's
    inputs arriving: counted apart, and kept out of the bytes;
  * a kernel accounting hook (``kernels.ops.kernel_hook``): each call of
    a hand-written kernel adds the kernel's own FLOP and byte formula
    (``kernels/work.py``), and the ops inside it are not counted, so a
    step counts the same whether the kernel (the card) or its plain
    version (the CPU) ran;
  * the kernels' launch counters, read around the step.

``shapes_only`` runs the step on the CPU under ``FakeTensorMode``: every
op dispatches as on the CPU, on tensors without data, so the CPU's count
of a published-width step costs host time only.

Everything here is extraction: no thresholds, no verdicts.  The engine's
geometry is mirrored exactly (prefill is a B=1 chunk, decode advances
every slot, block tables are padded to ``max_blocks_per_seq``), and the
steps are the engine's own, so what is traced IS what serves.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.core.costmodel import MeshShape
from repro_torch.kernels import ops as kops
from repro_torch.kernels import work as KW
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as ST
from repro_torch.serving.cache_manager import SLOT_STATE_KINDS
from repro_torch.serving.paged_cache import blocks_for
from repro_torch.serving.sampling import make_sampler


@dataclasses.dataclass(frozen=True)
class ServeGeom:
    """One serving geometry: the shapes every step is traced at.

    ``table_len`` (= max_blocks_per_seq * block_size) is the padded
    attention span — paged attention scores every query against that full
    (masked) capacity, which makes it the effective T for static cost.
    """
    slots: int = 4
    max_len: int = 64
    block_size: int = 8
    prefill_chunk: int = 16

    @property
    def max_blocks_per_seq(self) -> int:
        return blocks_for(self.max_len, self.block_size)

    @property
    def num_blocks(self) -> int:
        return self.slots * self.max_blocks_per_seq + 1      # +1: null block

    @property
    def table_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size


def _kinds(arch: ArchConfig) -> set:
    return {k for seg in arch.pattern for k in seg.blocks}


def step_kinds(arch: ArchConfig) -> tuple[str, ...]:
    """The step kinds the engine registers for this arch."""
    out = ("paged_prefill", "paged_decode")
    if _kinds(arch) & SLOT_STATE_KINDS:
        out += ("slot_admit",)
    return out


def build_plan(arch: ArchConfig, geom: ServeGeom, mesh=None):
    """The same ASA plan the engine builds for this serve shape; ``mesh``
    a ``DeviceMesh``, a ``MeshShape`` or None (one device)."""
    from repro_torch.launch.mesh import mesh_shape_of
    shape = ShapeSpec("serve", geom.max_len, geom.slots, "decode")
    if mesh is None:
        mesh = MeshShape(1, 1)
    elif not isinstance(mesh, MeshShape):
        mesh = mesh_shape_of(mesh)
    return AdaptiveScheduler(faithful=False).plan(arch, shape, mesh)


def frontend_array(arch: ArchConfig) -> Optional[np.ndarray]:
    """Admission-time modality input, iff the arch consumes one: vision
    patch embeddings or audio frame embeddings (transformer.admit_slot),
    zeros as the reference's audit workload sends."""
    if arch.frontend == "vision":
        return np.zeros((1, arch.n_img_tokens, arch.d_model), np.float32)
    if arch.frontend == "audio":
        return np.zeros((1, arch.encoder.seq_len, arch.d_model), np.float32)
    return None


@dataclasses.dataclass
class StepModel:
    """What the steps run on: ``params`` and ``pools`` as a step takes
    them, ``held`` the pools as the engine holds them (DTensors on a mesh,
    else ``pools``), and a placed engine's block functions."""
    params: dict
    pools: list
    held: list
    block_fns: Optional[dict] = None
    placed: object = None


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu")


def build_model(arch: ArchConfig, geom: ServeGeom, *, device=None,
                mesh=None, plan=None, params=None,
                shapes_only: bool = False) -> StepModel:
    """Params (``init_lm``, or ``params``) and pools
    (``init_paged_cache``) as the engine builds them.  With ``mesh`` they
    are placed by the plan (``serving/placement.py``) and the steps run
    on the placement's trees; ``shapes_only`` builds them under the
    caller's ``FakeTensorMode`` on the CPU."""
    from repro_torch import device as _device
    cdt = T.compute_dtype(arch)
    if shapes_only:
        if params is None:
            key = ("meta", arch)
            if key not in _MODELS:      # the shapes, drawn once an arch
                _MODELS[key] = T.init_lm(arch, device="meta",
                                         generator=torch.Generator())
            params = _MODELS[key]
        params = tree.map(_fake_like, params)
        pools = T.init_paged_cache(arch, geom.num_blocks, geom.block_size,
                                   device="cpu", dtype=cdt,
                                   slots=geom.slots)
        return StepModel(params, pools, pools)
    if mesh is None:
        dev = _device.resolve(device)
    else:
        from repro_torch.launch.mesh import mesh_device
        dev = mesh_device(mesh)
    if params is None:
        params = T.init_lm(arch, device=dev)
    pools = T.init_paged_cache(arch, geom.num_blocks, geom.block_size,
                               device=dev, dtype=cdt, slots=geom.slots)
    if mesh is None:
        return StepModel(params, pools, pools)
    from repro_torch.core import sharding as SH
    from repro_torch.serving.placement import Placement
    plan = plan or build_plan(arch, geom, mesh)
    specs = plan.paged_cache_specs()
    held = SH.place(pools, SH.shardings(specs, mesh))
    placed = Placement(arch, mesh, params, held, plan.param_specs(), specs)
    return StepModel(placed.step_params(), placed.step_pools, held,
                     placed.block_fns, placed)


def sampling_rows(B: int, vocab: int):
    """Per-row (temperature, top_k, top_p, seeds) host arrays as the
    engine passes them (``ContinuousBatchingEngine._sampling_rows``),
    every row stochastic so that the whole fused sampler runs."""
    return (np.full((B,), 0.8, np.float32),
            np.full((B,), min(50, vocab), np.int32),
            np.full((B,), 0.9, np.float32),
            np.arange(B, dtype=np.uint32))


def step_arguments(arch: ArchConfig, kind: str, geom: ServeGeom,
                   model: StepModel) -> tuple:
    """The argument tuple for one step kind, at exactly the shapes and
    types ``serving/engine.py`` calls it with: the host rows it moves to
    the device before the call as tensors on the device, the sampler's
    rows as numpy arrays."""
    dev = tree.leaves(model.pools)[0].device
    if kind == "slot_admit":
        return (model.params, model.pools, 0, frontend_array(arch))

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    prefill = kind == "paged_prefill"
    B = 1 if prefill else geom.slots
    S = geom.prefill_chunk if prefill else 1
    mbps = geom.max_blocks_per_seq
    # prefill chunks are int32 context slices, decode rows int64 (engine)
    tokens = (np.arange(B * S) % arch.vocab).reshape(B, S).astype(
        np.int32 if prefill else np.int64)
    positions = np.full((B,), 0 if prefill else geom.prefill_chunk,
                        np.int64)
    tables = np.arange(1, B * mbps + 1, dtype=np.int32).reshape(B, mbps)
    args = (model.params, model.pools, on_dev(tokens), on_dev(positions),
            on_dev(tables))
    if prefill:
        args += (on_dev(np.full((B,), S, np.int64)),)
    slot_ids = (on_dev(np.arange(B, dtype=np.int64))
                if _kinds(arch) & SLOT_STATE_KINDS else None)
    return args + (slot_ids,) + sampling_rows(B, arch.vocab)


def build_step_fn(arch: ArchConfig, kind: str, *, block_fns=None):
    """The step callable the engine registers for ``kind``."""
    if kind == "paged_prefill":
        return ST.make_paged_prefill_step(
            arch, sampler=make_sampler(arch.vocab), block_fns=block_fns)
    if kind == "paged_decode":
        return ST.make_paged_decode_step(
            arch, sampler=make_sampler(arch.vocab), block_fns=block_fns)
    if kind == "slot_admit":
        return ST.make_slot_admit_step(arch, block_fns=block_fns)
    raise ValueError(f"unknown serving step kind {kind!r}")


# ---------------------------------------------------------------------------
# the recorders
# ---------------------------------------------------------------------------

_FLOP_REGISTRY = None


def _flop_registry() -> dict:
    global _FLOP_REGISTRY
    if _FLOP_REGISTRY is None:
        from torch.utils.flop_counter import FlopCounterMode
        _FLOP_REGISTRY = FlopCounterMode(display=False).flop_registry
    return _FLOP_REGISTRY


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _span_bytes(t: torch.Tensor) -> int:
    """The memory an input spans: a broadcast (stride 0) dim counts once,
    so ``mm`` and the ``expand`` + ``bmm`` that ``matmul`` picks on other
    strides read the same bytes."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
            ) * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _returns(func) -> list:
    return [r.alias_info for r in func._schema.returns]


def _is_view(func) -> bool:
    infos = _returns(func)
    return (func._overloadpacket is torch.ops.aten._unsafe_view or bool(
        infos and all(a is not None and not a.is_write for a in infos)))


def _is_inplace(func) -> bool:
    return any(a is not None and a.is_write for a in _returns(func))


@contextlib.contextmanager
def _sync_check(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block (CUDA only;
    None: leave it as it is)."""
    if mode is None:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Recorder(TorchDispatchMode):
    """Counts what one step dispatches; see the module docstring."""

    def __init__(self, pool_keys: Optional[dict], cuda: bool,
                 shapes_only: bool = False):
        super().__init__()
        self.pool_keys = pool_keys        # storage key -> leaf bytes
        self.cuda = cuda
        self.shapes_only = shapes_only
        self.flops = 0
        self.bytes = 0
        self.by_op: collections.Counter = collections.Counter()  # bytes
        self.ops: set = set()
        self.syncs: collections.Counter = collections.Counter()
        self.h2d = 0
        self.h2d_bytes = 0
        self.pool_copies: list = []
        self.kernel_calls: collections.Counter = collections.Counter()
        self.paused = 0
        self.live = 0
        self.peak = 0

    # -- intermediates still alive (the CPU's temp_bytes) --------------
    def _release(self, n: int) -> None:
        self.live -= n

    def _track(self, outs) -> None:
        for t in outs:
            if isinstance(t, torch.Tensor):
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._release, n)
        self.peak = max(self.peak, self.live)

    # -- the kernel accounting hook ------------------------------------
    def kernel(self, name, fn, args, kwargs):
        self.add_kernel(name, *kernel_work(name, args, kwargs))
        self.paused += 1
        try:
            out = self._kernel_out(name, fn, args, kwargs)
        finally:
            self.paused -= 1
        self._track(tree_flatten(out)[0])
        return out

    def add_kernel(self, name, nbytes, flops) -> None:
        """Count one call of kernel ``name`` by its formula's work."""
        self.kernel_calls[name] += 1
        self.ops.add(f"kernel::{name}")
        self.bytes += nbytes
        self.by_op[f"kernel::{name}"] += nbytes
        self.flops += sum(flops.values())

    def _kernel_out(self, name, fn, args, kwargs):
        """What a kernel call returns: its wrapper's result, or its empty
        outputs in a shapes-only run."""
        return (kernel_outputs(name, args, kwargs) if self.shapes_only
                else fn(*args, **kwargs))

    def _copy_kind(self, func, args, kwargs, out) -> Optional[str]:
        packet = func._overloadpacket
        if packet is torch.ops.aten._to_copy:
            src, dst = args[0].device, out.device
        elif packet is torch.ops.aten.copy_:
            src, dst = args[1].device, args[0].device
        else:
            return None
        if src.type == "cpu" and dst.type != "cpu":
            return "h2d"
        if src.type != "cpu" and dst.type == "cpu":
            return "d2h"
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet is torch.ops.aten._local_scalar_dense:
            self.syncs[str(packet)] += 1
            with _sync_check(0 if self.cuda else None):
                return func(*args, **kwargs)
        if packet in (torch.ops.aten._to_copy, torch.ops.aten.copy_):
            # a copy across devices: run unchecked, then say which way
            with _sync_check(0 if self.cuda else None):
                out = func(*args, **kwargs)
            way = self._copy_kind(func, args, kwargs, out)
            if way == "d2h":
                self.syncs["device-to-host copy"] += 1
            if way == "h2d":
                self.h2d += 1
                self.h2d_bytes += _nbytes(out if packet is
                                          torch.ops.aten._to_copy
                                          else args[0])
            if way is not None:
                return out
        else:
            try:
                out = func(*args, **kwargs)
            except RuntimeError as e:
                if "synchroniz" not in str(e):
                    raise
                self.syncs[str(packet)] += 1
                with _sync_check(0):
                    out = func(*args, **kwargs)
        if self.paused or func.namespace != "aten" or _is_view(func):
            return out
        self.ops.add(str(packet))
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        nbytes = sum(_span_bytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        self.bytes += nbytes
        self.by_op[str(packet)] += nbytes
        fl = _flop_registry().get(packet)
        if fl is not None:
            self.flops += fl(*args, **kwargs, out_val=out)
        if not _is_inplace(func):
            self._track(outs)
            if self.pool_keys:
                read = [self.pool_keys[k] for k in
                        (_storage_key(t) for t in ins) if k in self.pool_keys]
                if read and outs and max(_nbytes(t) for t in outs) >= \
                        min(read):
                    self.pool_copies.append((str(packet),
                                             max(_nbytes(t) for t in outs)))
        return out


def _flash_work(args: tuple, kwargs: dict, backward: bool):
    """``flash_work`` of the adapter's (B, S, H, D) q and (B, T, Hkv, D)
    k, its flops by the inputs' type."""
    q, k = args[0], args[1]
    B, S, H, D = q.shape
    nbytes, flops = KW.flash_work(B, S, k.shape[1], H, k.shape[2], D,
                                  kwargs.get("causal", True),
                                  q.element_size(), backward=backward)
    return nbytes, {str(q.dtype).removeprefix("torch."): flops}


def kernel_work(name: str, args: tuple, kwargs: dict):
    """(bytes, flops by type) of one hand-written kernel call, from the
    arguments ``kernels/ops.py`` passes its wrapper."""
    if name in ("rmsnorm", "rmsnorm_split"):
        x, scale = args[0], args[1]
        D = x.shape[-1]
        return KW.rmsnorm_work(x.numel() // max(D, 1), D, x.element_size(),
                               scale.element_size())
    if name == "flash_attention":
        return _flash_work(args, kwargs, backward=False)
    if name == "ssd_scan":
        # the bytes of ``ssd_work``; the flops the scan's arithmetic (one
        # product each, whatever bf16 splits the kernel runs it in)
        x, Bm, h0 = args[0], args[1], args[5]
        B, S, H, P = x.shape
        G, N, Q = Bm.shape[2], Bm.shape[3], min(kwargs["chunk"], S)
        nbytes, _ = KW.ssd_work(B, S, H, P, N, G, Q, "float32",
                                x.element_size(), h0 is not None)
        return nbytes, {"float32": sum(KW.ssd_products(B, S, H, P, N, G,
                                                       Q))}
    raise ValueError(f"no work formula for kernel {name!r}")


def kernel_bwd_work(name: str, args: tuple, kwargs: dict, has_dh: bool):
    """(bytes, flops by type) of the backward kernel of one kernel call,
    from the forward's arguments as ``kernel_work`` takes them;
    ``has_dh``: the SSD scan's final state has a gradient."""
    if name in ("rmsnorm", "rmsnorm_split"):
        x, scale = args[0], args[1]
        D = x.shape[-1]
        return KW.rmsnorm_bwd_work(x.numel() // max(D, 1), D,
                                   x.element_size(), scale.element_size())
    if name == "flash_attention":
        return _flash_work(args, kwargs, backward=True)
    if name == "ssd_scan":
        # as the forward: ``ssd_bwd_work``'s bytes, one of each product
        x, Bm, h0 = args[0], args[1], args[5]
        B, S, H, P = x.shape
        G, N, Q = Bm.shape[2], Bm.shape[3], min(kwargs["chunk"], S)
        nbytes, _ = KW.ssd_bwd_work(B, S, H, P, N, G, Q, "float32",
                                    x.element_size(), h0 is not None, has_dh)
        cb, mbar, tri_p, st = KW.ssd_bwd_products(B, S, H, P, N, G, Q)
        return nbytes, {"float32": cb + mbar + 2 * tri_p + 5 * st}
    raise ValueError(f"no backward work formula for kernel {name!r}")


def kernel_outputs(name: str, args: tuple, kwargs: dict):
    """Empty outputs laid out as the kernel's wrapper allocates them (a
    shapes-only run calls no kernel and no plain version)."""
    x = args[0]
    if name in ("rmsnorm", "rmsnorm_split"):
        return torch.empty_like(x)
    if name == "flash_attention":
        qt = x.transpose(1, 2)
        out = torch.empty_like(qt)
        if out.stride(-1) != 1:
            out = torch.empty(qt.shape, dtype=qt.dtype, device=qt.device)
        return out.transpose(1, 2)
    if name == "ssd_scan":
        B, S, H, P = x.shape
        N = args[1].shape[3]
        return (torch.empty((B, S, H, P), dtype=torch.float32,
                            device=x.device),
                torch.empty((B, H, P, N), dtype=torch.float32,
                            device=x.device))
    raise ValueError(f"no outputs for kernel {name!r}")


def count(fn, *args, **kwargs) -> dict:
    """The recorder's count of one call ``fn(*args, **kwargs)`` outside a
    step, each hand-written kernel counted by its formula: its FLOPs,
    bytes and op names, and which kernels it called."""
    rec = _Recorder(None, False)
    with kops.kernel_hook(rec.kernel), rec:
        fn(*args, **kwargs)
    return {"flops": rec.flops, "bytes": rec.bytes, "ops": set(rec.ops),
            "kernel_calls": dict(rec.kernel_calls)}


def _launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd_scan as SSD
    return {"rmsnorm": RN.rmsnorm.launches,
            "rmsnorm_split": RN.rmsnorm_split.launches,
            "flash_attention": FA.flash_attention.launches,
            "ssd_scan": SSD.ssd_scan.launches}


def _outputs(kind: str, out) -> tuple:
    return (out,) if kind == "slot_admit" else tuple(out) \
        if isinstance(out, tuple) else (out,)


@dataclasses.dataclass
class TracedStep:
    """One step run once under the recorders, and what they saw."""
    arch: ArchConfig
    kind: str
    fn: object                     # the step callable
    args: tuple                    # the argument tuple it was called with
    model: Optional[StepModel]
    out: object = None             # what the step returned
    rec: Optional[_Recorder] = None
    launches: dict = dataclasses.field(default_factory=dict)
    temp_bytes: int = 0
    pool_keys_before: tuple = ()   # each passed pool leaf's storage
    sync_error: Optional[str] = None

    @property
    def cache_index(self) -> int:
        return 1                   # (params, cache, ...) for every kind


def run_step(arch: ArchConfig, kind: str, fn, args: tuple,
             model: Optional[StepModel] = None, *,
             shapes_only: bool = False) -> TracedStep:
    """Call ``fn(*args)`` once under the recorders; on CUDA under
    ``set_sync_debug_mode("error")``."""
    leaves = tree.leaves(args[1])
    dev = leaves[0].device
    cuda = dev.type == "cuda"
    keys = () if shapes_only else tuple(_storage_key(t) for t in leaves)
    rec = _Recorder(None if shapes_only else dict(zip(
        keys, (_nbytes(t) for t in leaves))), cuda, shapes_only)
    ts = TracedStep(arch, kind, fn, args, model, rec=rec,
                    pool_keys_before=keys)
    before = _launch_counts()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    try:
        with _sync_check("error" if cuda else None), \
                kops.kernel_hook(rec.kernel), rec:
            ts.out = fn(*args)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        ts.sync_error = str(e)
    if cuda:
        torch.cuda.synchronize(dev)
        ts.temp_bytes = torch.cuda.max_memory_allocated(dev) - base
    else:
        ts.temp_bytes = rec.peak
    after = _launch_counts()
    ts.launches = {k: after[k] - before[k] for k in after}
    return ts


_TRACES: dict = {}
_MODELS: dict = {}


def clear() -> None:
    """Drop every memoized trace and model (the card's memory)."""
    _TRACES.clear()
    _MODELS.clear()


def trace_step(arch: ArchConfig, kind: str, geom: ServeGeom, *,
               device=None, mesh=None, plan=None, params=None, model=None,
               shapes_only: bool = False) -> TracedStep:
    """Trace one serving step (``run_step`` over ``build_model``, or
    ``model``, and ``step_arguments``).  Unplaced traces are memoized per
    (arch, kind, geom, device, shapes_only) — the analyzers share them
    freely; traces on a ``mesh`` are not (the mesh's process group may
    not outlive the caller)."""
    key = (arch, kind, geom, str(device), shapes_only)
    if mesh is None and key in _TRACES:
        return _TRACES[key]
    mkey = key[:1] + key[2:]
    if model is not None:
        return _run(arch, kind, geom, model)
    if shapes_only:
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            model = build_model(arch, geom, params=params, shapes_only=True)
            ts = _run(arch, kind, geom, model, shapes_only=True)
    else:
        model = _MODELS.get(mkey) if mesh is None else None
        if model is None:
            model = build_model(arch, geom, device=device, mesh=mesh,
                                plan=plan, params=params)
            if mesh is None:
                _MODELS[mkey] = model
        ts = _run(arch, kind, geom, model)
    if mesh is None:
        _TRACES[key] = ts
    return ts


def _run(arch, kind, geom, model, *, shapes_only=False) -> TracedStep:
    fn = build_step_fn(arch, kind, block_fns=model.block_fns)
    if kind == "slot_admit" and model.placed is not None:
        step, placed = fn, model.placed

        def fn(params, cache, slot_id, frontend=None):
            # the placed engine's admission: split slot-state pools of a
            # block that gathers them around its calls gathered here too
            placed.admit(step, params, slot_id, frontend)
            return cache
    return run_step(arch, kind, fn, step_arguments(arch, kind, geom, model),
                    model, shapes_only=shapes_only)


# ---------------------------------------------------------------------------
# extraction reports
# ---------------------------------------------------------------------------

def _arg_bytes(a) -> int:
    if isinstance(a, np.ndarray):
        return a.nbytes
    if isinstance(a, (dict, list, tuple)):
        return sum(_arg_bytes(x) for x in tree.leaves(a))
    if isinstance(a, torch.Tensor):
        return _nbytes(a)
    return 0


def tree_def(t):
    """The container structure of a tree (dicts by key, lists, tuples),
    every leaf ``*``; a ``core.sharding.P`` spec is a leaf."""
    from repro_torch.core.sharding import P
    if isinstance(t, dict):
        return ("dict", tuple((k, tree_def(t[k])) for k in sorted(t)))
    if isinstance(t, (list, tuple)) and not isinstance(t, P):
        return (type(t).__name__, tuple(tree_def(v) for v in t))
    return "*"


def signature(args) -> tuple:
    """What ``jax.jit`` would retrace on, per argument: each tensor's
    shape, dtype and device; each numpy array's shape and dtype; the type
    of each Python scalar; where each None sits.  Trees recurse."""
    if isinstance(args, dict):
        return ("dict", tuple((k, signature(args[k])) for k in sorted(args)))
    if isinstance(args, (list, tuple)):
        return (type(args).__name__, tuple(signature(a) for a in args))
    if isinstance(args, torch.Tensor):
        return ("tensor", tuple(args.shape), str(args.dtype),
                str(args.device))
    if isinstance(args, np.ndarray):
        return ("ndarray", args.shape, str(args.dtype))
    if args is None:
        return None
    return type(args).__name__


def donation_report(ts: TracedStep) -> dict:
    """Which positional args the step updated in place and returned (the
    port's donation: the argument is returned as the same object, every
    tensor leaf in its own storage), whether the cache returned IS the
    cache passed and kept every leaf's storage, each argument's bytes,
    and the pool copies the step made."""
    cache = ts.args[ts.cache_index]
    outs = _outputs(ts.kind, ts.out)
    out_cache = next((o for o in outs if isinstance(o, (list, dict))), None)
    kept = (out_cache is not None
            and tree_def(out_cache) == tree_def(cache)
            and tuple(_storage_key(t) for t in tree.leaves(out_cache))
            == ts.pool_keys_before)
    returned = any(o is cache for o in outs)
    arg_bytes = tuple(_arg_bytes(a) for a in ts.args)
    donated = tuple(i for i, a in enumerate(ts.args)
                    if isinstance(a, (dict, list))
                    and any(o is a for o in outs)
                    and (i != ts.cache_index or kept))
    return {
        "donated_args": donated,
        "step_donation": ST.STEP_DONATION[ts.kind],
        "cache_returned": returned,
        "storage_kept": kept,
        "arg_bytes": arg_bytes,
        "cache_bytes": arg_bytes[ts.cache_index],
        "pool_copies": list(ts.rec.pool_copies),
    }


def op_census(ts: TracedStep) -> frozenset:
    """Every aten op name the step dispatched outside a hand-written
    kernel, and ``kernel::<name>`` for each kernel it called."""
    return frozenset(ts.rec.ops)


def host_syncs(ts: TracedStep) -> dict:
    """The host syncs inside the step by op (``aten._local_scalar_dense``,
    device-to-host copies, and on CUDA every op the sync debug mode
    stopped), the step's sanctioned host-to-device copies of its host
    arrays, and the error that stopped the step, if one did."""
    return {"syncs": dict(ts.rec.syncs), "h2d_copies": ts.rec.h2d,
            "h2d_bytes": ts.rec.h2d_bytes, "error": ts.sync_error}


def output_structure(ts: TracedStep):
    """The step's outputs with each tensor leaf a meta tensor of its shape
    and dtype (the twin of the reference's ``jax.eval_shape`` structs)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, torch.Tensor):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t
    return walk(ts.out)


def output_placements(ts: TracedStep):
    """For each pool leaf the step returned, in ``tree.leaves`` order of
    the engine's pool tree: the placements of the DTensor pool whose
    local tensor it is, or None where it is not one (the step returned a
    tensor the placed engine does not hold).  -> (tree_def of the
    returned cache, [(path, placements)])."""
    outs = _outputs(ts.kind, ts.out)
    cache = next((o for o in outs if isinstance(o, (list, dict))), None)
    if cache is None:
        return None, []
    held = ts.model.held
    got = []
    paths = tree.names(held)
    for path, h, t in zip(paths, tree.leaves(held), tree.leaves(cache)):
        local = h.to_local() if hasattr(h, "to_local") else h
        got.append((path, tuple(h.placements)
                    if hasattr(h, "placements")
                    and _storage_key(local) == _storage_key(t) else None))
    return tree_def(cache), got


def cost_report(ts: TracedStep) -> dict:
    """The step's counted cost: FLOPs (FlopCounterMode's formulas over
    every op, each hand-written kernel's own formula), bytes (each
    non-view op's tensor inputs and outputs, each kernel's formula; the
    sanctioned host-to-device copies apart), and temp_bytes (CUDA: the
    allocator's peak over the step less what was allocated before it; the
    CPU: the largest live set of the intermediates the recorder tracked).
    """
    return {
        "flops": float(ts.rec.flops),
        "bytes": float(ts.rec.bytes),
        "temp_bytes": int(ts.temp_bytes),
        "argument_bytes": int(sum(_arg_bytes(a) for a in ts.args)),
        "h2d_bytes": int(ts.rec.h2d_bytes),
        "kernel_calls": dict(ts.rec.kernel_calls),
    }

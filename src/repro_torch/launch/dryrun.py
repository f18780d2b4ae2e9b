"""Multi-pod dry run (twin of ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell: build the ASA plan,
build the step's arguments as shapes only, and run the real step ONCE as
rank 0 of a fake process group of 256 (16 x 16) or 512 (2 x 16 x 16)
ranks, under ``FakeTensorMode``: every op dispatches on tensors without
data, so nothing is allocated at production size, and every collective
the step makes goes to the fake group, which moves nothing.  What the
run records stands in for XLA's compiled facts:

  * ``memory``: per rank, the bytes of the step's arguments (this rank's
    shards of the params, optimizer state or cache, and its rows of the
    batch), of its outputs, of the outputs that are arguments updated in
    place (``alias``), and ``temp``: the peak of the live intermediates
    the step made beyond its arguments (``analysis/ircost.py``'s tracked
    live set);
  * ``cost``: counted FLOPs and bytes (``ircost``'s recorder: aten ops by
    FlopCounterMode's formulas, each hand-written kernel by its own
    formula through ``kernels.ops.kernel_hook`` and ``kernels/work.py``);
  * ``collectives``: per kind (all-gather, reduce-scatter, all-reduce,
    all-to-all), the count a step, the bytes of their results
    (``result_bytes``, the reference's measure) and the bytes that come
    from the other ranks (``bytes``: an all-gather's result less its
    input, a reduce-scatter's input less its result, an all-reduce's or
    all-to-all's tensor), seen at the ``torch.distributed`` calls the
    step makes: ``runtime/sharded.py``'s gathers (``_gather_dims``), its
    reductions and DTensor's;
  * ``model_flops`` (6 N D train, 2 N D inference) and ``trace_s``, the
    seconds the shapes-only run took, in the place of the reference's
    ``lower_s`` / ``compile_s``.

The reference's ``parse_collectives`` and ``_bytes_of_shape_str`` read
XLA's HLO text, which an eager step does not have: the recorded
``collectives`` take their place.

Train cells run the sharded train step (``runtime/steps.py`` with the
plan's shardings: weights gathered on use, the tensor-parallel blocks,
gradients reduced to their placements).  Prefill and decode cells run
``make_prefill_step`` / ``make_decode_step`` on contiguous caches placed
by the plan's ``cache_specs``, through ``runtime/sharded.py``'s
``plan_layout`` blocks: a block the plan shards over `model` computes on
its own share and takes its cache as placed (an attention cache's time
shards gathered around the attention), its tensor-parallel weights kept
as they lie and every other weight gathered on use; a block that runs
whole gathers its cache's shards around its call (``_rows_block``).
``--seq-shard`` is recorded in the plan's meta and costs, as the
reference's; the port's sharded step lays only the batch out over the
mesh.  ``--moe-ep`` takes the reference's EP-major MoE layout on MoE
archs (``core.sharding.MOE_EP_AXIS = "data"`` for the cell, and
``AdaptiveScheduler(moe_ep=True)``): the experts over `data`, their FF
dim over `model`, the tokens dispatched to them and back by all-to-all
(``models/moe.py``'s ``ExpertAllToAll``), which ``collectives["all-to-all"]``
records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape decode_32k --no-save --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``--device`` defaults to CUDA (the fake tensors' device type; nothing
runs on the card), ``cpu`` for the tests.  Records land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json`` and
print, each on a line of its own, as ``record <json>``; the exit status
is 1 when a cell failed.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch import tree
from repro_torch.analysis import ircost as IC
from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import components as C
from repro_torch.core import sharding as SH
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.core.costmodel import MeshShape
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_of
from repro_torch.models import blocks as B
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.optim.quantized import QLeaf
from repro_torch.runtime import sharded as SD
from repro_torch.runtime import steps as ST
from repro_torch.serving import placement as PL

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")

# archs whose optimizer states only fit with int8 moments
QUANTIZED_OPT = {"arctic-480b", "deepseek-v3-671b"}

# torch.distributed's ops by the collective they are: the process-group
# ops ``dist.*`` dispatches and the functional ones DTensor runs
COLLECTIVE_OPS = {
    "all-gather": ("c10d._allgather_base_", "c10d.allgather_",
                   "_c10d_functional.all_gather_into_tensor"),
    "reduce-scatter": ("c10d._reduce_scatter_base_", "c10d.reduce_scatter_",
                       "_c10d_functional.reduce_scatter_tensor"),
    "all-reduce": ("c10d.allreduce_", "_c10d_functional.all_reduce"),
    "all-to-all": ("c10d.alltoall_base_",
                   "_c10d_functional.all_to_all_single"),
}
_KIND_OF = {op: kind for kind, ops in COLLECTIVE_OPS.items() for op in ops}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_world(world: int, device):
    """A fake process group of ``world`` ranks in this process, this
    process rank 0, destroyed on exit.  Refuses when a group is up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group "
                           f"of {world} ranks, and one is already up: run "
                           "it in a process of its own")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _split_sums(args: tuple, kwargs: dict, width: int) -> None:
    """The all-reduce the split-row RMSNorm makes between its two
    launches: ``width`` fp32 sums a row over its group (1 forward, 2
    backward)."""
    group = kwargs.get("group")
    if group is not None:
        import torch.distributed as dist
        x = args[0]
        rows = x.numel() // max(x.shape[-1], 1)
        dist.all_reduce(torch.empty((rows, width), dtype=torch.float32,
                                    device=x.device), group=group)


class _KernelShapes(torch.autograd.Function):
    """A kernel call that autograd differentiates, in a shapes-only run:
    the forward returns the wrapper's empty outputs and saves what the
    port's autograd Function saves (the inputs; flash's output and the
    rows' logsumexp), so that remat drops them alike; the backward counts
    the backward kernel by its formula (``ircost.kernel_bwd_work``), makes
    its collectives and returns empty gradients.  The train step then
    counts the port's kernels forward and backward, never their plain
    versions."""

    @staticmethod
    def forward(ctx, rec, name, args, kwargs, *tensors):
        # the arguments without their tensors, which go through
        # save_for_backward
        ctx.rec, ctx.name, ctx.kwargs = rec, name, kwargs
        ctx.slots = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
        ctx.args = tuple(None if i in ctx.slots else a
                         for i, a in enumerate(args))
        ctx.set_materialize_grads(False)
        out = IC.kernel_outputs(name, args, kwargs)
        saved = list(tensors)
        if name == "flash_attention":
            B, S, H, _ = args[0].shape
            lse = torch.empty((B, H, S), dtype=torch.float32,
                              device=args[0].device)
            rec._track([lse])
            saved += [out, lse]
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, *grads):
        rec, name = ctx.rec, ctx.name
        args = list(ctx.args)
        for i, t in zip(ctx.slots, ctx.saved_tensors):
            args[i] = t
        has_dh = name == "ssd_scan" and grads[1] is not None
        rec.add_kernel(f"{name}_bwd", *IC.kernel_bwd_work(
            name, args, ctx.kwargs, has_dh))
        tensors = [t for t in args if isinstance(t, torch.Tensor)]
        rec.paused += 1
        try:
            if name == "rmsnorm_split":
                _split_sums(args, ctx.kwargs, 2)
            gs = [torch.empty_like(t) if need else None
                  for t, need in zip(tensors, ctx.needs_input_grad[4:])]
        finally:
            rec.paused -= 1
        rec._track([g for g in gs if g is not None])
        return (None, None, None, None, *gs)


class _Recorder(IC._Recorder):
    """ircost's recorder (shapes only) that also counts the collectives.
    A kernel call adds its formula's work and returns its wrapper's empty
    outputs, as ircost's; where autograd needs its gradient (a train
    step) through ``_KernelShapes``, whose backward counts the backward
    kernel by its formula."""

    def __init__(self):
        super().__init__(None, False, shapes_only=True)
        self.coll = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0, "result_bytes": 0})

    def _kernel_out(self, name, fn, args, kwargs):
        if name == "rmsnorm_split":
            _split_sums(args, kwargs, 1)
        tensors = [t for t in args if isinstance(t, torch.Tensor)]
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors):
            return _KernelShapes.apply(self, name, args, kwargs, *tensors)
        return super()._kernel_out(name, fn, args, kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = _KIND_OF.get(f"{func.namespace}.{func._opname}")
        if kind is not None:
            self._collective(kind, func, args, kwargs or {})
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _collective(self, kind, func, args, kwargs):
        ts = [t for t in torch.utils._pytree.tree_flatten((args, kwargs))[0]
              if isinstance(t, torch.Tensor)]
        functional = func.namespace == "_c10d_functional"
        if kind in ("all-gather", "reduce-scatter") and not functional:
            out, inp = IC._nbytes(ts[0]), IC._nbytes(ts[1])
        elif kind == "all-gather":      # (input, group size, group name)
            inp = IC._nbytes(ts[0])
            out = inp * args[1]
        elif kind == "reduce-scatter":  # (input, op, group size, name)
            inp = IC._nbytes(ts[0])
            out = inp // args[2]
        else:
            out = inp = IC._nbytes(ts[0])
        rec = self.coll[kind]
        rec["count"] += 1
        rec["result_bytes"] += out
        rec["bytes"] += (out - inp if kind == "all-gather" else
                         inp - out if kind == "reduce-scatter" else out)


def _placed_empty(shape, dtype, mesh, spec, device):
    """A DTensor of global ``shape`` placed by ``spec``: this rank's shard
    as an empty (fake) tensor."""
    from torch.distributed.tensor import DTensor
    pl = SH.placements(spec, mesh)
    local = torch.empty(SH.local_shape(tuple(shape), mesh, pl), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=tuple(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _place_tree(t, specs, mesh, device):
    return tree.unflatten(t, [
        _placed_empty(x.shape, x.dtype, mesh, s, device)
        for x, s in zip(tree.leaves(t), SH.spec_leaves(specs))])


def _resolve(arch, shape) -> tuple[ArchConfig, ShapeSpec]:
    return (get_arch(arch) if isinstance(arch, str) else arch,
            SHAPES[shape] if isinstance(shape, str) else shape)


def plan_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeSpec], *,
              multi_pod: bool, seq_shard: bool = False,
              opt8bit: bool = False, moe_ep: bool = False):
    """The cell's ASA plan and meta, as the reference's ``build_cell``
    makes them: -> (plan, meta, seq_ok).  ``moe_ep`` plans with the cost
    model's EP terms on a MoE arch (a dense arch is planned as without
    it); the plan's specs follow ``moe_ep_axis(arch, moe_ep)`` where they
    are read."""
    arch, shape = _resolve(arch, shape)
    ms = MeshShape(16, 16, pod=2 if multi_pod else 1)
    opt_preset = ("adamw8bit" if (arch.name in QUANTIZED_OPT or opt8bit)
                  else "adamw32")
    # seq-sharding the scan carry breaks on SSM families; batch-only there
    seq_ok = (seq_shard and arch.family not in ("ssm", "hybrid")
              and shape.kind != "decode" and shape.seq_len % ms.model == 0)
    sched = AdaptiveScheduler(faithful=False, opt_preset=opt_preset,
                              remat="full", seq_sharded=seq_ok,
                              moe_ep=moe_ep and arch.moe is not None)
    plan = sched.plan(arch, shape, ms)
    meta = {"arch": arch.name, "shape": shape.name,
            "mesh": _mesh_name(multi_pod), "opt_preset": opt_preset,
            "microbatches": plan.microbatches, "seq_shard": seq_ok,
            "method": plan.plan.method, "feasible": plan.plan.feasible,
            "predicted": plan.plan.cost,
            "assignment": {k: str(v) for k, v in plan.assignment.items()}}
    return plan, meta, seq_ok


def moe_ep_axis(arch: ArchConfig, moe_ep: bool):
    """The scope a cell's specs are made in: the EP-major layout
    (``MOE_EP_AXIS = "data"``) for ``--moe-ep`` on a MoE arch, else the
    default ("model"), as the reference's launcher sets it per cell."""
    return SH.moe_ep_axis("data" if moe_ep and arch.moe is not None
                          else "model")


def _frontend_shape(arch: ArchConfig, batch: int) -> Optional[tuple]:
    if arch.frontend == "vision":
        return (batch, arch.n_img_tokens, arch.d_model)
    if arch.frontend == "audio":
        return (batch, arch.encoder.seq_len, arch.d_model)
    return None


def build_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeSpec],
               *, multi_pod: bool, mesh, device, seq_shard: bool = False,
               opt8bit: bool = False, moe_ep: bool = False):
    """-> (fn, args, plan, meta, arg_bytes) for one cell: the step and its
    arguments, built as shapes only.  Call it under ``FakeTensorMode``
    with ``mesh`` a production mesh on a fake group."""
    arch, shape = _resolve(arch, shape)
    plan, meta, _ = plan_cell(arch, shape, multi_pod=multi_pod,
                              seq_shard=seq_shard, opt8bit=opt8bit,
                              moe_ep=moe_ep)
    ms = mesh_shape_of(mesh)
    Bsz, S = shape.global_batch, shape.seq_len
    with moe_ep_axis(arch, moe_ep):
        pspecs = plan.param_specs()
    params = _place_tree(C.abstract_params(arch), pspecs, mesh, device)
    # FS and uniform DP shard the batch over every mesh axis
    full_batch = plan.uniform in ("FS", "DP") and shape.kind == "train"
    rows = SH.batch_axes(ms, Bsz, full=full_batch)
    shards = 1
    for a in (rows if isinstance(rows, tuple) else (rows,) if rows else ()):
        shards *= {"pod": ms.pod, "data": ms.data, "model": ms.model}[a]
    cdt = T.compute_dtype(arch)
    fe_shape = _frontend_shape(arch, Bsz)
    fe = None if fe_shape is None else torch.empty(fe_shape, dtype=cdt,
                                                   device=device)

    p_bytes = _nbytes(params)
    if shape.kind == "train":
        # "full" per-layer remat, the reference's production default; FS
        # has one example a rank, so no grad accumulation
        if plan.uniform == "FS":
            plan.microbatches = 1
        optimizer = O.adamw(1e-4,
                            quantized=(meta["opt_preset"] == "adamw8bit"))
        sds = optimizer[0](C.abstract_params(arch))
        ospecs = SH.opt_state_specs(sds, pspecs, ms)

        def moment(sd, spec):
            if isinstance(sd, QLeaf):
                return QLeaf(_placed_empty(sd.q.shape, sd.q.dtype, mesh,
                                           spec.q, device),
                             _placed_empty(sd.scale.shape, sd.scale.dtype,
                                           mesh, spec.scale, device),
                             sd.shape, sd.signed)
            return _placed_empty(sd.shape, torch.float32, mesh, spec, device)

        def moments(m, specs):
            if m is None:
                return None
            return tree.unflatten(m, [moment(x, s) for x, s in zip(
                tree.leaves(m), SH.spec_leaves(specs))])
        opt_state = O.OptState(sds.step, moments(sds.mu, ospecs.mu),
                               moments(sds.nu, ospecs.nu), sds.extra)
        act_ns = SH.NamedSharding(mesh, SH.P(rows, None, None))
        step = ST.make_train_step(arch, optimizer,
                                  microbatches=plan.microbatches,
                                  remat="full", act_sharding=act_ns,
                                  grad_shardings=SH.shardings(pspecs, mesh))
        tok = torch.empty((Bsz, S), dtype=torch.int32, device=device)
        batch = {"tokens": tok, "labels": tok}
        if fe is not None:
            batch["frontend"] = fe
        meta["remat"] = "full"
        arg_bytes = (p_bytes + _nbytes([opt_state.mu, opt_state.nu])
                     + (2 * IC._nbytes(tok) + (IC._nbytes(fe) if fe is not None
                                               else 0)) // shards)
        return step, (params, opt_state, batch), plan, meta, arg_bytes

    cspecs = plan.cache_specs(Bsz)
    cache = _place_tree(T.init_cache(arch, Bsz, S, device="meta"), cspecs,
                        mesh, device)
    fn = _serving_fn(arch, shape.kind, params, pspecs, cspecs, mesh,
                     SH.P(rows, None))
    # this rank's rows of the batch (cache_specs lay them out alike)
    local = Bsz // shards
    tok = torch.empty((local, S if shape.kind == "prefill" else 1),
                      dtype=torch.int32, device=device)
    args = (None, tree.map(lambda x: x.to_local(), cache), tok)
    if shape.kind == "prefill" and fe is not None:
        args += (fe[:local],)
    arg_bytes = p_bytes + _nbytes(args[1:])
    return fn, args, plan, meta, arg_bytes


def _rows_block(fn, pls: dict, mesh):
    """``fn`` (``apply_block``'s signature) with the block's cache shards
    gathered around the call over every mesh dim but those that lay out
    the batch (dim 0 of one application's leaf: this rank computes its
    own rows), and this rank's slices written back after it."""
    D = SD._dt()

    def keep(pl):
        return tuple(p if SH.shard_dim(p) and SH.shard_dim(p)[0] == 0
                     else D.Replicate() for p in pl)

    def rows_only(pl):           # the placements of the gathered leaf
        return tuple(D.Replicate() if SH.shard_dim(p) and
                     SH.shard_dim(p)[0] == 0 else p for p in pl)

    def gather(local, pl):
        if isinstance(local, dict):
            return {k: gather(v, pl[k]) for k, v in local.items()}
        return SD._gather_dims(local, mesh, pl, keep(pl))

    def write_back(local, full, pl):
        for k, v in local.items():
            if isinstance(v, dict):
                write_back(v, full[k], pl[k])
            elif full[k] is not v:
                v.copy_(SH.shard_of(full[k], mesh, rows_only(pl[k])))

    def apply(p, kind, arch, x, *, cache=None, **kw):
        if cache is None:
            return fn(p, kind, arch, x, cache=cache, **kw)
        full = gather(cache, pls)
        x, _, aux = fn(p, kind, arch, x, cache=full, **kw)
        write_back(cache, full, pls)
        return x, cache, aux
    return apply


def _serving_fn(arch, kind, params, pspecs, cspecs, mesh, batch_spec):
    """The prefill or decode step ``fn(_, cache, tokens[, frontend])`` on
    placed params and caches, on this rank's rows of the batch
    (``batch_spec``), its blocks' functions as ``fn.block_fns``:
    ``plan_layout``'s blocks
    where the plan shards them over `model` (each on its own share and
    its cache as placed: ``runtime/sharded.py``), their tensor-parallel
    leaves kept as they lie and every other param gathered on use (the
    working tree); every other block's cache shards gathered around its
    call (``_rows_block``)."""
    pns = SH.shardings(pspecs, mesh)
    roles, tp_fns = SD.plan_layout(arch, pspecs, mesh, batch_spec, cspecs)
    lays = SD.layouts(pns, roles)
    live = [p.to_local() for p in tree.leaves(params)]
    pls = SH.map_specs(lambda ns: ns.placements, SH.shardings(cspecs, mesh))
    app = PL._pls_map(SD._shift, pls)
    block_fns = {k: v for k, v in tp_fns.items() if k == "encoder"}
    for si, seg in enumerate(arch.pattern):
        for bi in range(len(seg.blocks)):
            fn = tp_fns.get(si, {}).get(bi)
            if fn is None and app[si][f"b{bi}"] is not None:
                fn = _rows_block(B.apply_block, app[si][f"b{bi}"], mesh)
            if fn is not None:
                block_fns.setdefault(si, {})[bi] = fn
    make = ST.make_prefill_step if kind == "prefill" else ST.make_decode_step
    step = make(arch, block_fns=block_fns)

    def fn(_, cache, *rest):
        with torch.no_grad():
            return step(SD.working_tree(params, live, lays, mesh), cache,
                        *rest)
    fn.block_fns = block_fns
    return fn


def model_flops(arch_name: str, shape_name: str) -> float:
    """6·N·D (train) / 2·N·D (inference), N = active params."""
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    n_active = C.active_param_count(arch)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch       # decode: 1 token/seq


def _leaves(t) -> list:
    """The tensors of a tree's leaves as they are (a DTensor whole; an
    int8 moment's codes and scales)."""
    out = []
    for x in tree.leaves(t):
        for y in ((x.q, x.scale) if isinstance(x, QLeaf) else (x,)):
            if isinstance(y, torch.Tensor):
                out.append(y)
    return out


def _local_bytes(x) -> int:
    return IC._nbytes(x.to_local() if hasattr(x, "to_local") else x)


def _nbytes(t) -> int:
    """This rank's bytes of a tree's tensors (a DTensor's shard)."""
    return sum(_local_bytes(x) for x in _leaves(t))


def _output_bytes(out, args) -> tuple[int, int]:
    """(bytes of the step's output tensors, of those that are argument
    tensors returned as they are: updated in place).  Identity is the
    leaf's own, a DTensor's and not its shard's: ``to_local`` may make a
    new view each call."""
    ins = {id(x) for x in _leaves(args)}
    outs = _leaves(out)
    return (sum(_local_bytes(x) for x in outs),
            sum(_local_bytes(x) for x in outs if id(x) in ins))


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeSpec], *,
             multi_pod: bool = False, save: bool = True,
             seq_shard: bool = False, opt8bit: bool = False,
             moe_ep: bool = False, tag: str = "", device="cuda") -> dict:
    """One cell, end to end, in this process (which must have no process
    group up) -> its record (saved unless ``save`` is False)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    arch, shape = _resolve(arch, shape)
    rec = {"arch": arch.name, "shape": shape.name, "tag": tag,
           "mesh": _mesh_name(multi_pod)}
    ok, why = shape_applicable(arch, shape)
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        _save(rec, save)
        return rec
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256, device):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args, plan, meta, arg_bytes = build_cell(
                    arch, shape, multi_pod=multi_pod, mesh=mesh,
                    device=device, seq_shard=seq_shard, opt8bit=opt8bit,
                    moe_ep=moe_ep)
                rec.update(meta)
                r = _Recorder()
                with kops.kernel_hook(r.kernel), r:
                    out = fn(*args)
                out_bytes, alias = _output_bytes(out, args)
    except Exception as e:      # a failure here is a fault of the port
        rec.update({"status": "FAILED", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(limit=8)})
        _save(rec, save)
        return rec
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": out_bytes,
                     "alias_size_in_bytes": alias,
                     "temp_size_in_bytes": r.peak}
    rec["cost"] = {"flops": r.flops, "bytes": r.bytes,
                   "kernel_calls": dict(r.kernel_calls)}
    coll = {k: dict(r.coll[k]) for k in COLLECTIVE_OPS}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    rec["collectives"] = coll
    rec["model_flops"] = (model_flops(arch.name, shape.name)
                          if arch.name in ARCHS and shape.name in SHAPES
                          else None)
    rec["trace_s"] = round(time.time() - t0, 3)
    rec["status"] = "ok"
    print(f"memory: {rec['memory']}")
    print(f"cost: flops {r.flops:.6g} bytes {r.bytes:.6g}")
    print(f"collectives: {json.dumps(coll)}")
    _save(rec, save)
    return rec


def _save(rec: dict, save: bool):
    if not save:
        return
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    name = (f"{rec['arch']}__{rec['shape']}__"
            f"{rec['mesh'].replace('x', '_')}{tag}.json")
    (OUT_DIR / name).write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel activations (optimized mode)")
    ap.add_argument("--opt8bit", action="store_true",
                    help="int8 optimizer moments for any arch")
    ap.add_argument("--moe-ep", action="store_true",
                    help="EP-major MoE layout: experts over `data`, an "
                         "all-to-all dispatch")
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")

    n_fail = 0
    for a, s in cells:
        print(f"\n=== dry-run {a} x {s} ({_mesh_name(args.multi_pod)}) ===",
              flush=True)
        rec = run_cell(a, s, multi_pod=args.multi_pod, save=not args.no_save,
                       seq_shard=args.seq_shard, opt8bit=args.opt8bit,
                       moe_ep=args.moe_ep, tag=args.tag, device=args.device)
        coll = rec.get("collectives", {}).get("total_bytes", 0)
        print(f"-> {rec['status']} (trace {rec.get('trace_s', '-')}s) "
              f"coll={coll / 1e9:.2f}GB/dev "
              + (rec.get("reason", "") or rec.get("error", "")), flush=True)
        print("record " + json.dumps(rec, default=str), flush=True)
        n_fail += rec["status"] == "FAILED"
    print(f"\ndry-run finished: {len(cells)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

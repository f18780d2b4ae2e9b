"""Trainer — the paper's Algorithm 1 as a production loop (twin of
``repro/runtime/trainer.py``).

Integrates: ASA planning + periodic re-planning (re-profile -> re-solve ->
redistribute -> rebuild the step), grad-accum microbatching,
checkpoint/restart (exact resume: step, data offset), elastic mesh resize,
and live step-time monitoring.  The mesh is a ``DeviceMesh``
(``launch/mesh.py``); params and moments are DTensors placed by the plan
and trained by the sharded step (``runtime/steps.py``,
``runtime/sharded.py``) — on a 1 x 1 mesh too, through the same DTensor
code.

Differences from the reference, each deliberate:
  * the default scheduler plans for the mesh's device: ``H100_SXM`` on
    CUDA, the reference's default (``TPU_V5E``) on the CPU;
  * a uniform DP or FS plan lays the batch over every mesh axis (the
    Strategy's definition and the cost model's assumption; the
    reference's Trainer keeps it on `data`), when each microbatch
    divides; the math is the same either way;
  * the step time fed to the monitor is the largest over the ranks, so
    that every rank takes the same re-planning decision.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import hardware as HW
from repro_torch.core import sharding as SH
from repro_torch.core.asa import AdaptiveScheduler, SchedulePlan
from repro_torch.launch.mesh import mesh_device, mesh_shape_of
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.optim.quantized import QLeaf
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.runtime import steps as ST


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    microbatches: int = 0            # 0 = take from the ASA plan
    remat: str = "none"
    impl: str = "xla"
    checkpoint_every: int = 200
    replan_every: int = 0            # 0 = only on monitor trigger
    quantized_opt: bool = False
    seed: int = 0


def hardware_for(mesh) -> HW.HardwareProfile:
    """The profile a mesh's device plans with: the H100 on CUDA, the
    reference's default on the CPU."""
    return HW.H100_SXM if mesh.device_type == "cuda" else HW.TPU_V5E


class Trainer:
    def __init__(self, arch: ArchConfig, shape: ShapeSpec, mesh,
                 cfg: TrainConfig = TrainConfig(), *,
                 scheduler: Optional[AdaptiveScheduler] = None,
                 checkpoint_dir: Optional[str] = None):
        self.arch, self.shape, self.mesh, self.cfg = arch, shape, mesh, cfg
        self.sched = scheduler or AdaptiveScheduler(hardware_for(mesh),
                                                    faithful=False)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.opt = O.adamw(
            cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps),
            quantized=cfg.quantized_opt)
        self.step = 0
        self.data_offset = 0
        self.plan: Optional[SchedulePlan] = None
        self._step_fn = None
        self._replan(init=True)

    # ------------------------------------------------------------------
    def _microbatches(self) -> int:
        return self.cfg.microbatches or self.plan.microbatches

    def _specs(self):
        ms = mesh_shape_of(self.mesh)
        pspecs = self.plan.param_specs()
        pns = SH.shardings(pspecs, self.mesh)
        rows = self.shape.global_batch // self._microbatches()
        full = (self.plan.uniform in ("DP", "FS") and rows % ms.chips == 0)
        act_ns = SH.NamedSharding(
            self.mesh, SH.P(SH.batch_axes(ms, rows, full=full), None, None))
        return pspecs, pns, act_ns

    def _replan(self, init: bool = False):
        ms = mesh_shape_of(self.mesh)
        new_plan = self.sched.plan(self.arch, self.shape, ms)
        changed = (self.plan is None
                   or new_plan.assignment != self.plan.assignment)
        self.plan = new_plan
        if not (changed or init):
            return False
        pspecs, pns, act_ns = self._specs()
        self._pspecs, self._pns = pspecs, pns
        self._step_fn = ST.make_train_step(
            self.arch, self.opt, microbatches=self._microbatches(),
            impl=self.cfg.impl, remat=self.cfg.remat, act_sharding=act_ns,
            grad_shardings=pns, clip_norm=self.cfg.clip_norm)
        return changed

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None, params=None):
        """The port's ``init_lm`` (a generator on the mesh's device seeded
        with ``seed``, default ``cfg.seed``; every rank draws the same
        params) placed by the plan, and zero moments placed like them
        (int8 moments by their flat specs).  ``params``: a whole param
        tree to place instead (the same on every rank, e.g. the
        reference's, converted)."""
        dev = mesh_device(self.mesh)
        seed = self.cfg.seed if seed is None else seed
        full = (T.init_lm(self.arch, device=dev, seed=seed) if params is None
                else tree.map(lambda x: x.to(dev), params))
        params = tree.unflatten(full, [
            SH.distribute(x, ns) for x, ns in
            zip(tree.leaves(full), tree.leaves(self._pns))])
        del full
        return params, self._init_opt(params)

    def _init_opt(self, params):
        from torch.distributed.tensor import zeros as dzeros
        dev = mesh_device(self.mesh)
        opt_init, _ = self.opt
        sds = opt_init(tree.map(lambda p: torch.empty(
            p.shape, dtype=p.dtype, device="meta"), params))
        ospecs = SH.opt_state_specs(sds, self._pspecs,
                                    mesh_shape_of(self.mesh))

        def moment(sd, spec):
            if isinstance(sd, QLeaf):
                q = QLeaf.from_dense(torch.zeros(sd.shape, device=dev),
                                     sd.signed)
                return QLeaf(SH.distribute(q.q, SH.NamedSharding(
                    self.mesh, spec.q)), SH.distribute(
                    q.scale, SH.NamedSharding(self.mesh, spec.scale)),
                    sd.shape, sd.signed)
            return dzeros(tuple(sd.shape), dtype=torch.float32,
                          device_mesh=self.mesh,
                          placements=SH.placements(spec, self.mesh))

        def moments(m, specs):
            if m is None:
                return None
            return tree.unflatten(m, [moment(x, s) for x, s in zip(
                tree.leaves(m), SH.spec_leaves(specs))])
        return O.OptState(sds.step, moments(sds.mu, ospecs.mu),
                          moments(sds.nu, ospecs.nu), sds.extra)

    def maybe_restore(self, params, opt_state, *, step: Optional[int] = None):
        """Restart-from-checkpoint (the latest, or ``step``), resharded to
        the current plan and mesh (every leaf placed like the one it
        replaces)."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return params, opt_state
        self.ckpt.wait()
        restored, manifest = self.ckpt.restore(
            {"params": params, "opt": opt_state}, step=step)
        self.step = manifest["step"]
        self.data_offset = manifest.get("data_offset", self.step)
        return restored["params"], restored["opt"]

    # ------------------------------------------------------------------
    def _slowest(self, dt: float) -> float:
        t = torch.tensor([dt], dtype=torch.float64,
                         device=mesh_device(self.mesh))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def _redistribute(self, params, opt_state):
        """Move params and fp32 moments to the current plan's placements
        (the int8 moments' flat specs depend on the mesh only)."""
        def move(x, ns):
            return x.redistribute(self.mesh, ns.placements)
        params = tree.unflatten(params, [move(x, ns) for x, ns in zip(
            tree.leaves(params), tree.leaves(self._pns))])

        def moments(m):
            if m is None or any(isinstance(x, QLeaf)
                                for x in tree.leaves(m)):
                return m
            return tree.unflatten(m, [move(x, ns) for x, ns in zip(
                tree.leaves(m), tree.leaves(self._pns))])
        return params, O.OptState(opt_state.step, moments(opt_state.mu),
                                  moments(opt_state.nu), opt_state.extra)

    def train(self, params, opt_state, data_iter, *, steps: int,
              log_every: int = 10, on_metrics: Optional[Callable] = None):
        metrics_hist = []
        for _ in range(steps):
            batch = next(data_iter)
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(params, opt_state,
                                                       batch)
            m = {k: float(v) for k, v in metrics.items()}   # syncs
            dt = self._slowest(time.perf_counter() - t0)
            self.step += 1
            self.data_offset += 1

            if self.sched.record_step(dt) or (
                    self.cfg.replan_every
                    and self.step % self.cfg.replan_every == 0):
                if self._replan():     # strategy switch: redistribute
                    params, opt_state = self._redistribute(params, opt_state)

            if self.ckpt and self.step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(self.step, {"params": params, "opt": opt_state},
                               extra={"data_offset": self.data_offset})
            m["step_time_s"] = dt
            metrics_hist.append(m)
            if on_metrics and self.step % log_every == 0:
                on_metrics(self.step, m)
        return params, opt_state, metrics_hist

    # ------------------------------------------------------------------
    def resize(self, new_mesh, params, opt_state):
        """Elastic rescale: re-plan on the new mesh and re-place the live
        state there (each leaf gathered, then distributed by the new
        plan; the values are copied, never recomputed)."""
        from torch.distributed.tensor import distribute_tensor
        self.mesh = new_mesh
        self._replan(init=True)
        params = tree.unflatten(params, [
            SH.distribute(x.full_tensor(), ns) for x, ns in zip(
                tree.leaves(params), tree.leaves(self._pns))])
        ospecs = SH.opt_state_specs(O.OptState(
            opt_state.step, *(None if m is None else tree.map(_meta, m)
                              for m in (opt_state.mu, opt_state.nu)),
            opt_state.extra), self._pspecs, mesh_shape_of(new_mesh))

        def place(x, spec):
            if isinstance(x, QLeaf):
                return QLeaf(*(distribute_tensor(
                    t.full_tensor(), new_mesh, SH.placements(s, new_mesh))
                    for t, s in ((x.q, spec.q), (x.scale, spec.scale))),
                    x.shape, x.signed)
            return distribute_tensor(x.full_tensor(), new_mesh,
                                     SH.placements(spec, new_mesh))

        def moments(m, specs):
            if m is None:
                return None
            return tree.unflatten(m, [place(x, s) for x, s in zip(
                tree.leaves(m), SH.spec_leaves(specs))])
        opt_state = O.OptState(opt_state.step,
                               moments(opt_state.mu, ospecs.mu),
                               moments(opt_state.nu, ospecs.nu),
                               opt_state.extra)
        return params, opt_state


def _meta(x):
    """A meta stand-in with ``x``'s global shape (a QLeaf keeps its own:
    its codes' and scales' shapes are what the specs read)."""
    if isinstance(x, QLeaf):
        return QLeaf(torch.empty(tuple(x.q.shape), device="meta"),
                     torch.empty(tuple(x.scale.shape), device="meta"),
                     x.shape, x.signed)
    return torch.empty(tuple(x.shape), device="meta")

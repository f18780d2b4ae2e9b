"""AdaptiveScheduler — the paper's ASA (twin of ``repro/core/asa.py``; the
planning is pure host code, so a plan equals the reference's for the same
inputs).

plan()        profile -> estimate -> solve -> sharding specs   (Alg. 1, 4-9)
replan()      periodic re-profile + strategy update            (Alg. 1, 21-23)
baselines()   static DP / MP / HP plans for comparison         (paper Table I)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import components as C
from repro_torch.core import hardware as HW
from repro_torch.core import sharding as SH
from repro_torch.core import solver as SV
from repro_torch.core.costmodel import CostModel, MeshShape
from repro_torch.core.profiler import ComponentProfiler, StepMonitor
from repro_torch.core.strategy import ALL_STRATEGIES


@dataclasses.dataclass
class SchedulePlan:
    arch: ArchConfig
    shape: ShapeSpec
    mesh: MeshShape
    plan: SV.Plan
    comps: list
    microbatches: int = 1

    @property
    def assignment(self):
        return self.plan.assignment

    @property
    def uniform(self) -> Optional[str]:
        """'DP'|'MP'|'HP' when the winning plan is a static uniform scheme."""
        if self.plan.method.startswith("uniform-"):
            return self.plan.method.split("-", 1)[1]
        return None

    def param_specs(self):
        return SH.param_specs(self.arch, self.assignment, self.mesh)

    def cache_specs(self, batch: int):
        return SH.cache_specs(self.arch, self.assignment, self.mesh, batch)

    def paged_cache_specs(self):
        return SH.paged_cache_specs(self.arch, self.assignment, self.mesh)

    def summary(self) -> str:
        rows = [f"  {c.name:<36s} -> {self.assignment[c.name]}"
                for c in self.comps]
        cost = self.plan.cost
        head = (f"ASA plan [{self.arch.name} x {self.shape.name} "
                f"mesh=({self.mesh.pod}x{self.mesh.data}x{self.mesh.model})] "
                f"method={self.plan.method} feasible={self.plan.feasible}\n"
                f"  predicted: t_comp={cost['t_comp']*1e3:.2f}ms "
                f"t_comm={cost['t_comm']*1e3:.2f}ms "
                f"comm%={cost['comm_fraction']*100:.1f} "
                f"mem/dev={cost['mem_per_device']/1e9:.2f}GB")
        if any(str(s) in ("MP", "HP") for s in self.assignment.values()):
            rows.append("  compute: tensor-parallel over `model` in dense attn "
                        "blocks only; every other component under MP/HP "
                        "gathers its weights on use")
        return "\n".join([head] + rows)


OPT_PRESETS = {
    # bytes per param: (grad, optimizer-state)
    "adamw32": (4.0, 12.0),     # fp32 grads + fp32 m/v/master
    "adamw8bit": (2.0, 2.0),    # bf16 grad accum + int8 m/v (optim/quantized.py)
}


class AdaptiveScheduler:
    def __init__(self, hw: HW.HardwareProfile = HW.TPU_V5E, *,
                 faithful: bool = True, remat: str = "selective",
                 mem_limit_fraction: float = 0.9, opt_preset: str = "adamw32",
                 seq_sharded: bool = False, moe_ep: bool = False):
        self.hw = hw
        self.faithful = faithful
        self.remat = remat
        self.seq_sharded = seq_sharded
        self.moe_ep = moe_ep
        self.mem_limit_fraction = mem_limit_fraction
        self.grad_bytes, self.opt_bytes = OPT_PRESETS[opt_preset]
        self.opt_preset = opt_preset
        self.profiler = ComponentProfiler()
        self.monitor = StepMonitor()
        self._calibration: dict[str, float] = {}

    # ------------------------------------------------------------------
    def _cost_model(self, mesh: MeshShape, mode: str,
                    microbatches: int = 1,
                    fs_allowed: bool = True) -> CostModel:
        return CostModel(hw=self.hw, mesh=mesh, mode=mode,
                         faithful=self.faithful, remat=self.remat,
                         microbatches=microbatches,
                         seq_sharded=self.seq_sharded,
                         fs_allowed=fs_allowed,
                         moe_ep=self.moe_ep,
                         grad_bytes=self.grad_bytes,
                         opt_bytes_per_param=self.opt_bytes,
                         calibration=self._calibration or None)

    def plan(self, arch: ArchConfig, shape: ShapeSpec,
             mesh: MeshShape) -> SchedulePlan:
        """Solve; escalate grad-accumulation microbatching until the
        activation working set fits (train only)."""
        comps = C.components_for_shape(arch, shape)
        limit = self.hw.hbm_bytes * self.mem_limit_fraction
        max_mb = max(1, shape.global_batch // (mesh.data * mesh.pod)) \
            if shape.kind == "train" else 1
        # FS (ZeRO-3 over all chips) needs one whole example per chip
        fs_ok = (shape.kind == "train"
                 and shape.global_batch % mesh.chips == 0)
        best = None        # (plan, mb) — cheapest feasible across mb values
        mb = 1
        while True:
            cm = self._cost_model(mesh, shape.kind, microbatches=mb,
                                  fs_allowed=fs_ok)
            plan = SV.solve(cm, comps, mem_limit=limit)
            if plan.feasible and (best is None
                                  or plan.cost["time"] < best[0].cost["time"]):
                best = (plan, mb)
            if mb >= max_mb:
                break
            mb *= 2
        if best is None:
            best = (plan, mb)
        return SchedulePlan(arch, shape, mesh, best[0], comps,
                            microbatches=best[1])

    def baselines(self, arch: ArchConfig, shape: ShapeSpec,
                  mesh: MeshShape) -> dict[str, SV.Plan]:
        comps = C.components_for_shape(arch, shape)
        cm = self._cost_model(mesh, shape.kind)
        return {str(s): SV.solve_uniform(cm, comps, s) for s in ALL_STRATEGIES}

    # ------------------------------------------------------------------
    def record_step(self, step_time_s: float) -> bool:
        """Feed live step times; True => caller should replan()."""
        return self.monitor.update(step_time_s)

    def calibrate(self, measured: dict[str, float],
                  predicted: dict[str, float]):
        """Update per-component calibration factors from measurements."""
        for name, t in measured.items():
            p = predicted.get(name)
            if p and p > 0:
                self._calibration[name] = max(t / p, 1e-3)

    def replan(self, arch: ArchConfig, shape: ShapeSpec,
               mesh: MeshShape) -> SchedulePlan:
        """Re-solve with current calibration (Alg. 1 line 22)."""
        return self.plan(arch, shape, mesh)

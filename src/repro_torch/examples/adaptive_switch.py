"""Adaptive re-planning demo, the paper's Algorithm 1, lines 21-23 (twin
of ``examples/adaptive_switch.py``): ASA plans move with the input shape
and with calibration, and the Trainer re-plans while it trains.

    PYTHONPATH=src python -m repro_torch.examples.adaptive_switch \\
        [--device cpu]

``plan_shift_demo`` is pure planning (qwen3-8b on a 16 x 16 mesh, the
reference's default hardware profile); ``live_replan_demo`` trains a
two-layer model on a world-1 mesh of ``--device`` and re-plans every 20
steps.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ArchConfig, Segment, ShapeSpec
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.core.costmodel import MeshShape
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh, shutdown
from repro_torch.runtime.trainer import TrainConfig, Trainer


def plan_shift_demo() -> list[dict]:
    """qwen3-8b x train_4k / prefill_32k / decode_32k on 16 x 16, then
    decode_32k re-solved after calibrating the mixers 3x slower than
    predicted -> one row a plan: shape, method, strategy histogram,
    microbatches, predicted step time (s)."""
    sched = AdaptiveScheduler(faithful=False, opt_preset="adamw8bit")
    arch = ARCHS["qwen3-8b"]
    rows = []
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        plan = sched.plan(arch, SHAPES[shape_name], MeshShape(16, 16))
        hist = {}
        for s in plan.assignment.values():
            hist[str(s)] = hist.get(str(s), 0) + 1
        rows.append({"shape": shape_name, "method": plan.plan.method,
                     "hist": hist, "microbatches": plan.microbatches,
                     "time": plan.plan.cost["time"]})
        print(f"{arch.name} x {shape_name:<12} -> {plan.plan.method:<14} "
              f"{hist} mb={plan.microbatches} "
              f"t={plan.plan.cost['time']*1e3:.1f}ms")

    # profiling feedback: attention measured 3x slower than predicted ->
    # the scheduler re-solves with calibrated costs (Alg 1 line 22)
    comps = plan.comps
    predicted = {c.name: 1.0 for c in comps}
    measured = {c.name: (3.0 if "mixer" in c.name else 1.0) for c in comps}
    sched.calibrate(measured, predicted)
    plan2 = sched.replan(arch, SHAPES["decode_32k"], MeshShape(16, 16))
    rows.append({"shape": "decode_32k (calibrated)",
                 "method": plan2.plan.method, "hist": None,
                 "microbatches": plan2.microbatches,
                 "time": plan2.plan.cost["time"]})
    print(f"after calibration        -> {plan2.plan.method:<14} "
          f"t={plan2.plan.cost['time']*1e3:.1f}ms")
    return rows


class _CountingTrainer(Trainer):
    """A Trainer that records the step of each re-plan after the first."""

    def __init__(self, *args, **kwargs):
        self.replans = []
        super().__init__(*args, **kwargs)

    def _replan(self, init: bool = False):
        if not init:
            self.replans.append(self.step)
        return super()._replan(init)


def live_replan_demo(device=None, *, replan_every: int = 20,
                     steps: int = 60):
    """The Trainer on a world-1 mesh, re-planning every ``replan_every``
    steps (and on step-time drift) -> (the metrics of each step, the
    steps it re-planned at)."""
    arch = ArchConfig(name="switch-demo", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab=512, pattern=(Segment(("attn",), 2),),
                      dtype="float32", param_dtype="float32")
    shape = ShapeSpec("demo", 64, 8, "train")
    mesh = make_host_mesh(device=device)
    try:
        tr = _CountingTrainer(arch, shape, mesh,
                              TrainConfig(lr=1e-3, replan_every=replan_every,
                                          total_steps=100))
        params, opt = tr.init_state()
        data = SyntheticLM(arch.vocab, 64, 8)
        params, opt, hist = tr.train(params, opt, data, steps=steps)
    finally:
        shutdown()
    print(f"trained {steps} steps with replan_every={replan_every}; "
          f"re-planned at steps {tr.replans}; "
          f"final loss {hist[-1]['loss']:.3f}")
    return hist, tr.replans


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return plan_shift_demo(), live_replan_demo(args.device)


if __name__ == "__main__":
    main()

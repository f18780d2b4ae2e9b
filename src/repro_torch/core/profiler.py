"""Profiling — ASA Algorithm 1 lines 6-7 and the re-profile trigger (21-23);
twin of ``repro/core/profiler.py``.

Two layers:
  * ComponentProfiler — measures the time of per-component apply fns
    (initial profiling phase).  Measurements are turned into *calibration
    factors* (measured / predicted) for the cost model.  The reference
    jits each fn and times it on the host's clock; the port runs it
    eagerly and times it by the device its tensors live on: CUDA events
    on the card, ``time.perf_counter`` on the CPU (``time_fn``).
  * StepMonitor — EMA of live step times; signals drift (paper: "if
    communication patterns changed significantly -> re-profile").
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import tree


@dataclasses.dataclass
class ProfileResult:
    name: str
    mean_s: float
    n: int


def _on_cuda(args) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in tree.leaves(list(args)))


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Mean seconds of one ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls.  When a tensor among ``args`` lies on CUDA the calls
    run between two CUDA events (device time of the whole sequence,
    launch gaps included); otherwise on ``time.perf_counter``."""
    if _on_cuda(args):
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    for _ in range(warmup):
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


class ComponentProfiler:
    """Times per-component fns and derives calibration factors."""

    def __init__(self):
        self.measurements: dict[str, ProfileResult] = {}

    def profile(self, name: str, fn: Callable, *args,
                iters: int = 5) -> ProfileResult:
        mean = time_fn(fn, *args, iters=iters)
        res = ProfileResult(name, mean, iters)
        self.measurements[name] = res
        return res

    def calibration(self, predicted: dict[str, float]) -> dict[str, float]:
        """measured/predicted per component (1.0 when unmeasured)."""
        out = {}
        for name, pred in predicted.items():
            m = self.measurements.get(name)
            if m is not None and pred > 0:
                out[name] = max(m.mean_s / pred, 1e-3)
        return out


class StepMonitor:
    """EMA step-time drift detector -> re-profile trigger.

    Train-time use: the trainer feeds step wall times and re-plans when
    ``update`` returns True.  Serve-time use: the continuous-batching
    engine feeds every ``step()`` duration and exports ``ema`` /
    ``drift_fraction()`` as telemetry gauges (``step_time_ema_s`` /
    ``step_time_drift``) plus a ``replan_triggers`` counter — the
    re-profile signal the adaptive serving scheduler (ROADMAP item 3)
    subscribes to.
    """

    def __init__(self, alpha: float = 0.1, drift_threshold: float = 0.25,
                 min_steps: int = 20):
        self.alpha = alpha
        self.threshold = drift_threshold
        self.min_steps = min_steps
        self.ema: Optional[float] = None
        self.baseline: Optional[float] = None
        self.steps = 0

    def update(self, step_time_s: float) -> bool:
        """Record one step; returns True when drift warrants re-planning."""
        self.steps += 1
        self.ema = (step_time_s if self.ema is None
                    else (1 - self.alpha) * self.ema + self.alpha * step_time_s)
        if self.baseline is None and self.steps >= self.min_steps:
            self.baseline = self.ema
        if self.baseline is None or self.steps < self.min_steps:
            return False
        drift = abs(self.ema - self.baseline) / self.baseline
        if drift > self.threshold:
            self.baseline = self.ema      # re-arm after trigger
            return True
        return False

    def drift_fraction(self) -> Optional[float]:
        """Current |ema - baseline| / baseline, or None before the
        baseline exists — the live drift gauge telemetry exports."""
        if self.baseline is None or self.ema is None:
            return None
        return abs(self.ema - self.baseline) / self.baseline

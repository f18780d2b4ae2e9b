"""Step-time drift detection (``StepMonitor``, copy of the class in
``repro/core/profiler.py``): an EMA of live step times that signals drift,
the re-profile trigger.  The reference module's ``time_fn`` and
``ComponentProfiler`` serve the planner and are not ported yet.
"""
from __future__ import annotations

from typing import Optional


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

"""Serving telemetry primitives: histograms, counters, gauges and
sliding-window aggregates.

This module is the measurement substrate under ``ServingMetrics`` (the
backward-compatible facade in serving/metrics.py) and the exporters
(serving/export.py).  Everything here is host-side, allocation-light and
O(1) per observation — these objects sit on the engine's per-step hot
path, so none of them may grow with run length:

``LogHistogram``
    Log-bucketed histogram with O(1) ``record`` and approximate
    percentiles (p50/p95/p99 via :meth:`percentile`).  Bucket boundaries
    grow geometrically by ``growth`` (default 1.1), so any percentile
    estimate is within ~``growth - 1`` relative error of the true value —
    the right trade for latency-shaped (long-tailed, positive)
    distributions, and the reason memory stays fixed (~a few hundred int
    buckets) no matter how many samples stream in.  ``count``/``total``/
    ``vmin``/``vmax`` are exact; ``total`` accumulates in record order, so
    ``mean`` is bit-identical to ``sum(samples)/len(samples)``.

``Counter`` / ``Gauge``
    A monotonically increasing count and a last-value-wins measurement.
    Deliberately tiny — they exist so exporters can enumerate "everything
    countable" and "everything settable" uniformly.

``SlidingWindow``
    Timestamped samples over the trailing ``window_s`` seconds, expired
    lazily on access.  This is what turns lifetime aggregates into the
    *recent-workload* signal vector the adaptive scheduler (ROADMAP
    item 3) consumes: arrival rate, prompt-length mix, prefix hit rate
    and cache pressure *over the last N seconds*, not since process
    start.  Memory is bounded by events-in-window, and all timestamps are
    caller-supplied (the engine's injectable clock), so tests drive it
    with a synthetic clock.

``Telemetry``
    A flat name -> primitive registry tying the four together, so the
    Prometheus/JSONL exporters can walk every metric without knowing the
    engine's internals.

``quantile``
    Exact linear-interpolation quantile over a bounded sample list
    (numpy-free twin of ``np.quantile(..., method="linear")``) — used for
    per-request TTFT/TPOT percentiles, where the sample count is bounded
    by the number of requests and exactness is worth keeping.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Optional


def quantile(xs, q: float) -> Optional[float]:
    """Exact q-quantile (linear interpolation, numpy's default method) of
    an iterable of numbers; None when empty.  For bounded sample sets —
    unbounded streams belong in a LogHistogram."""
    s = sorted(xs)
    if not s:
        return None
    if len(s) == 1:
        return float(s[0])
    pos = q * (len(s) - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        self.value += n


class Gauge:
    """Last-value-wins measurement; None until first set."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, x: Optional[float]) -> None:
        self.value = x


class LogHistogram:
    """Log-bucketed histogram: O(1) record, fixed memory, approximate
    percentiles.

    Bucket 0 holds values below ``lo`` (including zero — queue depths and
    durations are never negative, and negatives clamp there too); bucket i
    (1..n) holds ``[lo * growth**(i-1), lo * growth**i)``; the last bucket
    is the overflow for values >= ``hi``.  ``percentile`` walks the
    cumulative counts and returns the geometric midpoint of the target
    bucket, clamped into the observed [vmin, vmax] — relative error is
    bounded by the bucket width (~``growth - 1``).
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e5,
                 growth: float = 1.1):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad histogram shape lo={lo} hi={hi} "
                             f"growth={growth}")
        self.lo, self.hi, self.growth = lo, hi, growth
        self._log_growth = math.log(growth)
        self._n = math.ceil(math.log(hi / lo) / self._log_growth)
        self.counts = [0] * (self._n + 2)      # [under, 1..n, over]
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def _index(self, x: float) -> int:
        if x < self.lo:
            return 0
        return min(int(math.log(x / self.lo) / self._log_growth) + 1,
                   self._n + 1)

    def upper_bound(self, idx: int) -> float:
        """Exclusive upper bound of bucket ``idx`` (inf for the overflow
        bucket) — what a Prometheus ``le`` label reports."""
        if idx <= 0:
            return self.lo
        if idx > self._n:
            return math.inf
        return self.lo * self.growth ** idx

    def record(self, x: float) -> None:
        self.count += 1
        self.total += x
        if self.vmin is None or x < self.vmin:
            self.vmin = x
        if self.vmax is None or x > self.vmax:
            self.vmax = x
        self.counts[self._index(x)] += 1

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-th percentile (q in [0, 1]); None when empty."""
        if not self.count:
            return None
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                if i == 0:
                    est = self.lo / 2.0
                elif i > self._n:
                    est = self.vmax
                else:
                    lo_b = self.lo * self.growth ** (i - 1)
                    est = math.sqrt(lo_b * self.upper_bound(i))
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def nonzero_buckets(self):
        """[(upper_bound, cumulative_count)] over non-empty buckets —
        sparse cumulative rendering for Prometheus exposition."""
        out, cum = [], 0
        for i, c in enumerate(self.counts):
            if c:
                cum += c
                out.append((self.upper_bound(i), cum))
        return out

    def summary(self) -> dict:
        """JSON-able digest: exact count/mean/min/max plus approximate
        p50/p95/p99 (all None when no samples)."""
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class SlidingWindow:
    """Timestamped samples over the trailing ``window_s`` seconds.

    ``record(t, value)`` appends; every accessor takes ``now`` and first
    drops samples older than ``now - window_s``.  Timestamps must be
    non-decreasing (they come from one engine clock).  Memory is bounded
    by the number of events inside the window.
    """

    def __init__(self, window_s: float = 10.0):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0 (got {window_s})")
        self.window_s = window_s
        self._q: deque = deque()               # (t, value)

    def record(self, t: float, value: float = 1.0) -> None:
        self._q.append((t, value))
        self._expire(t)

    def _expire(self, now: float) -> None:
        cutoff = now - self.window_s
        q = self._q
        while q and q[0][0] <= cutoff:
            q.popleft()

    def values(self, now: float) -> list:
        self._expire(now)
        return [v for _, v in self._q]

    def count(self, now: float) -> int:
        self._expire(now)
        return len(self._q)

    def rate(self, now: float) -> float:
        """Events per second over the window."""
        return self.count(now) / self.window_s

    def total(self, now: float) -> float:
        self._expire(now)
        return sum(v for _, v in self._q)

    def mean(self, now: float) -> Optional[float]:
        self._expire(now)
        return (sum(v for _, v in self._q) / len(self._q)
                if self._q else None)

    def vmax(self, now: float) -> Optional[float]:
        self._expire(now)
        return max((v for _, v in self._q), default=None)

    def quantile(self, q: float, now: float) -> Optional[float]:
        return quantile(self.values(now), q)


class Telemetry:
    """Flat name -> primitive registry.

    One instance per ServingMetrics; exporters iterate ``counters`` /
    ``gauges`` / ``histograms`` / ``windows`` without knowing which
    subsystem registered what.  ``window_s`` is the shared horizon for
    every window created through :meth:`window`.
    """

    def __init__(self, window_s: float = 10.0):
        self.window_s = window_s
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, LogHistogram] = {}
        self.windows: dict[str, SlidingWindow] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str, **kw) -> LogHistogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = LogHistogram(**kw)
        return h

    def window(self, name: str) -> SlidingWindow:
        w = self.windows.get(name)
        if w is None:
            w = self.windows[name] = SlidingWindow(self.window_s)
        return w

    def snapshot(self, now: float) -> dict:
        """JSON-able dump of every registered primitive."""
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self.histograms.items()},
            "windows": {k: {"count": w.count(now), "rate": w.rate(now),
                            "mean": w.mean(now), "max": w.vmax(now)}
                        for k, w in self.windows.items()},
        }

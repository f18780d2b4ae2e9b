"""Serving metrics: per-request TTFT/TPOT plus engine-level telemetry
(host-only copy of ``repro/serving/metrics.py``).

``ServingMetrics`` is the backward-compatible facade over the telemetry
primitives in serving/telemetry.py — every summary key that existed
before the telemetry layer keeps its name and meaning, and the means are
bit-identical (running totals accumulate in record order, exactly like
``sum(samples)/len(samples)`` over the old unbounded lists).  What
changed underneath:

  * per-step samples (queue depth, slot occupancy, block utilization,
    phase durations, step time) live in fixed-memory ``LogHistogram``s —
    the old ``*_samples`` lists grew one entry per engine step forever;
  * a ``Telemetry`` registry exposes every counter/gauge/histogram to the
    exporters (serving/export.py: Prometheus text + JSONL snapshots);
  * sliding windows turn lifetime aggregates into the *recent-workload*
    signal vector the adaptive scheduler (ROADMAP item 3) needs:
    ``window_signals()`` reports arrival rate, prompt-length mix, prefix
    hit rate, cache pressure, queue depth and decode throughput over the
    trailing ``window_s`` seconds, plus the StepMonitor drift gauge;
  * ``summary()`` distinguishes "no data" from zero: a run with no
    finished requests reports ``None`` latencies/throughput instead of a
    0.0 that reads as infinitely fast (serve_bench skips such rows).

All timestamps are caller-supplied floats from ONE clock: the engine
stamps every lifecycle point (submit / first token / finish) and every
step with its injectable ``clock``, so a test driving the engine with a
synthetic clock gets coherent TTFT/TPOT *and* window expiry end to end.
A request that has not reached a lifecycle point yet reports ``None`` for
the latencies that depend on it and is skipped by the ``summary()``
aggregates.  ``summary()`` reports EVERY submitted id — in-flight
requests appear with ``None`` latencies and are counted in ``in_flight``.

``to_json()`` emits the full report; ``write()`` drops it next to the
benchmark outputs via an atomic temp-file + rename (a crash mid-write
never leaves truncated JSON).

Cache pressure: the engine samples ``PagedKVCache.utilization`` every
step (``block_utilization_mean/max``) and reports prefix-cache admission
matches (``prefix_hit_rate`` — matched tokens / looked-up context tokens,
0.0 when sharing is off).
"""
from __future__ import annotations

import json
import time
from typing import Optional

from repro_torch.serving.export import atomic_write_text
from repro_torch.serving.telemetry import Telemetry, quantile

# engine phases with their own duration histogram + trace track
PHASES = ("admission", "prefix_match", "prefill", "decode", "sample_sync")


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


class ServingMetrics:
    def __init__(self, *, window_s: float = 10.0):
        self.submit_t: dict[int, float] = {}
        self.first_token_t: dict[int, float] = {}
        self.finish_t: dict[int, float] = {}
        self.token_counts: dict[int, int] = {}
        # engine-lifetime aggregates: the per-id dicts above hold only the
        # LATEST lifecycle of a reused id, so completions/tokens/span must
        # accumulate separately or a resubmitted id silently deflates them
        self.finished_requests = 0
        self.finished_tokens = 0
        self._first_submit_t: Optional[float] = None
        self._last_finish_t: Optional[float] = None
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.preemptions = 0
        self.engine_steps = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.finish_reasons: dict[str, int] = {}
        # live references injected by the engine (dicts/callables stay
        # current without a push per step); None when used standalone
        self.scheduler_stats: Optional[dict] = None
        self.cache_stats = None              # () -> dict, engine-injected
        # telemetry registry: per-step streams in fixed-memory histograms,
        # recent-workload signals in sliding windows
        t = self.telemetry = Telemetry(window_s=window_s)
        self.queue_depth = t.histogram("queue_depth", lo=1.0, hi=1e6,
                                       growth=1.3)
        self.slot_occupancy = t.histogram("slot_occupancy", lo=1e-3, hi=2.0)
        self.block_utilization = t.histogram("block_utilization", lo=1e-3,
                                             hi=2.0)
        self.step_time = t.histogram("step_time_s")
        self.phase = {p: t.histogram(f"phase_{p}_s") for p in PHASES}
        self._win_arrivals = t.window("arrivals")          # value=prompt_len
        self._win_finished = t.window("finished_tokens")   # value=n_tokens
        self._win_queue = t.window("queue_depth")
        self._win_occupancy = t.window("slot_occupancy")
        self._win_util = t.window("block_utilization")
        self._win_hit = t.window("prefix_hit_tokens")
        self._win_lookup = t.window("prefix_lookup_tokens")
        self._g_step_ema = t.gauge("step_time_ema_s")
        self._g_step_drift = t.gauge("step_time_drift")
        self._c_replan = t.counter("replan_triggers")
        # newest engine-clock stamp seen: the default "now" for window
        # queries, so summary() is deterministic under synthetic clocks
        self._last_t: Optional[float] = None

    def _stamp(self, now: Optional[float]) -> float:
        # sanctioned fallback for standalone (engine-less) use only: every
        # engine call site passes its injected clock's ``now`` explicitly
        t = time.perf_counter() if now is None else now  # reprolint: disable=clock-injection
        if self._last_t is None or t > self._last_t:
            self._last_t = t
        return t

    # -- request lifecycle --------------------------------------------------
    def on_submit(self, rid: int, now: Optional[float] = None,
                  prompt_len: Optional[int] = None):
        t = self._stamp(now)
        self.submit_t[rid] = t
        if self._first_submit_t is None or t < self._first_submit_t:
            self._first_submit_t = t
        # a reused id (finished request resubmitted, or a fresh request
        # recycling it) starts a NEW lifecycle: without this, the
        # first-write-wins on_first_token kept the PREVIOUS run's stamp and
        # fabricated a negative TTFT (first < submit).  Preemption-resume
        # never passes through here, so its TTFT preservation is unaffected;
        # the finished_* aggregates keep the old run's contribution.
        self.first_token_t.pop(rid, None)
        self.finish_t.pop(rid, None)
        self.token_counts.pop(rid, None)
        self._win_arrivals.record(t, 0.0 if prompt_len is None
                                  else float(prompt_len))

    def on_first_token(self, rid: int, now: Optional[float] = None):
        # only the first time: a preempted+resumed request keeps its TTFT
        if rid not in self.first_token_t:
            self.first_token_t[rid] = self._stamp(now)

    def on_finish(self, rid: int, n_tokens: int,
                  now: Optional[float] = None,
                  reason: Optional[str] = None):
        t = self._stamp(now)
        self.finish_t[rid] = t
        self.token_counts[rid] = n_tokens
        self.finished_requests += 1
        self.finished_tokens += n_tokens
        if reason is not None:
            self.finish_reasons[reason] = \
                self.finish_reasons.get(reason, 0) + 1
        if self._last_finish_t is None or t > self._last_finish_t:
            self._last_finish_t = t
        self._win_finished.record(t, float(n_tokens))

    def on_preempt(self, rid: int):
        self.preemptions += 1

    def on_prefix_match(self, hit_tokens: int, lookup_tokens: int,
                        now: Optional[float] = None):
        """One admission-time prefix lookup: ``hit_tokens`` of the
        ``lookup_tokens``-token context were served from cached blocks."""
        self.prefix_hit_tokens += hit_tokens
        self.prefix_lookup_tokens += lookup_tokens
        t = self._stamp(now)
        self._win_hit.record(t, float(hit_tokens))
        self._win_lookup.record(t, float(lookup_tokens))

    # -- engine step --------------------------------------------------------
    def on_step(self, queue_depth: int, busy_slots: int, slots: int,
                block_utilization: Optional[float] = None,
                now: Optional[float] = None):
        t = self._stamp(now)
        self.engine_steps += 1
        self.queue_depth.record(queue_depth)
        occ = busy_slots / max(slots, 1)
        self.slot_occupancy.record(occ)
        self._win_queue.record(t, float(queue_depth))
        self._win_occupancy.record(t, occ)
        if block_utilization is not None:
            self.block_utilization.record(block_utilization)
            self._win_util.record(t, block_utilization)

    def on_phase(self, name: str, dur_s: float):
        """One engine phase execution (only phases that did work — the
        per-phase breakdown measures time spent *doing*, so zero-work
        dispatch overhead never dilutes the distributions)."""
        self.phase[name].record(dur_s)

    def on_step_time(self, dur_s: float, ema: Optional[float] = None,
                     drift: Optional[float] = None,
                     triggered: bool = False):
        """Wall time of one full engine step plus the StepMonitor's view:
        EMA, current drift fraction vs baseline, and whether this step
        tripped the re-profile trigger the adaptive scheduler subscribes
        to (core/profiler.StepMonitor)."""
        self.step_time.record(dur_s)
        self._g_step_ema.set(ema)
        self._g_step_drift.set(drift)
        if triggered:
            self._c_replan.inc()

    # -- report -------------------------------------------------------------
    def request_report(self, rid: int) -> dict:
        """Latency report for one request id.  Missing lifecycle points
        yield ``None`` (submitted-not-started has no TTFT; started-not-
        finished has no TPOT) — never a negative latency fabricated from a
        defaulted timestamp."""
        submit = self.submit_t.get(rid)
        first = self.first_token_t.get(rid)
        finish = self.finish_t.get(rid)
        n = self.token_counts.get(rid, 0)
        ttft = None if submit is None or first is None else first - submit
        if first is None or finish is None:
            tpot = None
        else:
            # time-per-output-token after the first
            tpot = (finish - first) / max(n - 1, 1)
        return {"id": rid, "n_tokens": n, "ttft_s": ttft, "tpot_s": tpot}

    def window_signals(self, now: Optional[float] = None) -> dict:
        """The adaptive scheduler's input vector, over the trailing
        ``window_s`` seconds of engine time: arrival rate, prompt-length
        mix, prefix hit rate, cache/queue pressure, decode throughput and
        the step-time drift gauge.  ``now`` defaults to the newest stamp
        seen, so the vector is deterministic under synthetic clocks."""
        t = self._last_t if now is None else now
        if t is None:                  # nothing recorded yet
            t = 0.0
        w = self._win_arrivals
        plens = w.values(t)
        lookup = self._win_lookup.total(t)
        return {
            "window_s": self.telemetry.window_s,
            "t": t,
            "arrival_rate_hz": w.rate(t),
            "prompt_len_mean": _mean(plens),
            "prompt_len_p50": quantile(plens, 0.5),
            "prompt_len_p95": quantile(plens, 0.95),
            "prompt_len_max": max(plens, default=None),
            "prefix_hit_rate": (self._win_hit.total(t) / lookup
                                if lookup else None),
            "block_pressure_mean": self._win_util.mean(t),
            "block_pressure_max": self._win_util.vmax(t),
            "queue_depth_mean": self._win_queue.mean(t),
            "slot_occupancy_mean": self._win_occupancy.mean(t),
            "tokens_per_sec": self._win_finished.total(t)
            / self.telemetry.window_s,
            "finished_per_sec": self._win_finished.rate(t),
            "step_time_ema_s": self._g_step_ema.value,
            "step_time_drift": self._g_step_drift.value,
            "replan_triggers": self._c_replan.value,
        }

    def summary(self) -> dict:
        # every submitted id, finished or not — submitted-but-unfinished
        # requests used to vanish from the report entirely even though
        # request_report handles them (None latencies)
        all_ids = sorted(set(self.submit_t) | set(self.finish_t))
        reqs = [self.request_report(r) for r in all_ids]
        ttfts = [r["ttft_s"] for r in reqs if r["ttft_s"] is not None]
        tpots = [r["tpot_s"] for r in reqs if r["tpot_s"] is not None]
        # engine-lifetime totals (NOT sums over the per-id dicts, which only
        # hold a reused id's latest lifecycle)
        total_tokens = self.finished_tokens
        if self._first_submit_t is not None and self._last_finish_t is not None:
            span = self._last_finish_t - self._first_submit_t
        else:
            span = 0.0
        out = {
            "requests": reqs,
            "completed": self.finished_requests,
            "in_flight": sum(1 for r in self.submit_t
                             if r not in self.finish_t),
            "total_tokens": total_tokens,
            # None (not 0.0) when nothing finished: a rate of zero reads as
            # "measured and terrible", absence reads as "no data" — and an
            # empty run's 0.0 TTFT used to read as perfect latency
            "tokens_per_sec": total_tokens / span if span > 0 else None,
            "ttft_mean_s": _mean(ttfts),
            "ttft_p50_s": quantile(ttfts, 0.5),
            "ttft_p95_s": quantile(ttfts, 0.95),
            "ttft_p99_s": quantile(ttfts, 0.99),
            "ttft_max_s": max(ttfts, default=None),
            "tpot_mean_s": _mean(tpots),
            "tpot_p50_s": quantile(tpots, 0.5),
            "tpot_p95_s": quantile(tpots, 0.95),
            "tpot_p99_s": quantile(tpots, 0.99),
            "queue_depth_mean": self.queue_depth.mean,
            "queue_depth_max": self.queue_depth.vmax,
            "slot_occupancy_mean": self.slot_occupancy.mean,
            "block_utilization_mean": self.block_utilization.mean,
            "block_utilization_max": self.block_utilization.vmax,
            "prefix_hit_rate": (self.prefix_hit_tokens
                                / self.prefix_lookup_tokens
                                if self.prefix_lookup_tokens else 0.0),
            "preemptions": self.preemptions,
            "engine_steps": self.engine_steps,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "finish_reasons": dict(self.finish_reasons),
            "phases": {p: h.summary() for p, h in self.phase.items()
                       if h.count},
            "step_time": self.step_time.summary(),
            "window": self.window_signals(),
        }
        if self.scheduler_stats is not None:
            out["scheduler"] = dict(self.scheduler_stats)
        if self.cache_stats is not None:
            out["cache"] = self.cache_stats()
        return out

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Compact periodic snapshot (one JSONL line): the windowed signal
        vector plus lifetime counters — no per-request list."""
        snap = {
            "completed": self.finished_requests,
            "in_flight": sum(1 for r in self.submit_t
                             if r not in self.finish_t),
            "total_tokens": self.finished_tokens,
            "preemptions": self.preemptions,
            "engine_steps": self.engine_steps,
            "window": self.window_signals(now),
        }
        if self.scheduler_stats is not None:
            snap["scheduler"] = dict(self.scheduler_stats)
        return snap

    def to_json(self, **extra) -> str:
        return json.dumps({**self.summary(), **extra}, indent=2)

    def write(self, path: str, **extra) -> None:
        """Atomic write (temp file + rename): a crash mid-write leaves the
        previous report intact, never truncated JSON next to bench
        results."""
        atomic_write_text(path, self.to_json(**extra) + "\n")

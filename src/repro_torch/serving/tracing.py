"""Span-based tracer emitting Chrome trace-event JSON (Perfetto-loadable);
a copy of ``repro/serving/tracing.py``.

The engine owns at most ONE tracer (``ContinuousBatchingEngine(tracer=
ChromeTracer())``); when it owns none, tracing costs nothing — every
emission site is behind an ``if tracer is not None`` and no clock reads,
dict builds or list appends happen.  A serve run with ``--trace-out``
(repro_torch/launch/serve.py) drops the JSON next to the metrics; open it at
https://ui.perfetto.dev (or chrome://tracing) to see:

  * one named track (``tid``) per engine phase — admission, prefix-match,
    prefill chunk, decode step, sample host-sync — carrying balanced
    B/E duration spans stamped from the engine's own clock values (the
    same floats the phase histograms record, so trace and metrics never
    disagree);
  * an async ``request`` track per request id: a ``b``/``e`` lifecycle
    span from submit to finish (finish_reason in the end event's args)
    with ``n`` instant annotations for admitted / first_token / preempt /
    resume — preemption shows up as the request going back to the queue
    mid-span, exactly how the scheduler experienced it;
  * counter tracks (``ph: "C"``) for queue depth and block-pool
    utilization sampled once per engine step.

Timestamps are microseconds relative to the first event (Chrome's ``ts``
convention); events are sorted by ``ts`` on export so the emitted JSON is
monotonic regardless of emission order within a step.

``validate_chrome_trace`` is the schema gate used by tests and the CI
smoke job: required keys per event, monotonic ``ts``, balanced B/E per
phase track, balanced b/e per request id.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.serving.export import atomic_write_text

# fixed track layout: one tid per engine phase, one shared tid for the
# async request-lifecycle spans (async events nest by id, not tid)
PHASE_TRACKS = {"admission": 1, "prefix_match": 2, "prefill": 3,
                "decode": 4, "sample_sync": 5}
REQUEST_TRACK = 10
COUNTER_TRACK = 0


class ChromeTracer:
    """Collects Chrome trace events; write() drops them atomically.

    All timestamps are caller-supplied floats from one clock (the
    engine's) — the tracer never reads a clock itself, so a synthetic
    test clock produces a fully deterministic trace.
    """

    def __init__(self, *, pid: int = 0, process_name: str = "serving-engine"):
        self.pid = pid
        self.process_name = process_name
        self.events: list[dict] = []
        self._origin: Optional[float] = None

    def _ts(self, t: float) -> float:
        if self._origin is None:
            self._origin = t
        return (t - self._origin) * 1e6        # seconds -> microseconds

    # -- phase spans --------------------------------------------------------
    def phase(self, name: str, t0: float, t1: float, **args) -> None:
        """One balanced B/E duration span on the phase's own track."""
        tid = PHASE_TRACKS[name]
        b = {"name": name, "ph": "B", "ts": self._ts(t0),
             "pid": self.pid, "tid": tid}
        if args:
            b["args"] = args
        self.events.append(b)
        self.events.append({"name": name, "ph": "E", "ts": self._ts(t1),
                            "pid": self.pid, "tid": tid})

    # -- counters -----------------------------------------------------------
    def counter(self, name: str, t: float, value: float) -> None:
        self.events.append({"name": name, "ph": "C", "ts": self._ts(t),
                            "pid": self.pid, "tid": COUNTER_TRACK,
                            "args": {name: value}})

    # -- per-request lifecycle spans (async, keyed by request id) -----------
    def _req_event(self, ph: str, rid: int, name: str, t: float,
                   args: Optional[dict]) -> None:
        ev = {"name": name, "cat": "request", "ph": ph, "id": rid,
              "ts": self._ts(t), "pid": self.pid, "tid": REQUEST_TRACK}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def request_begin(self, rid: int, t: float, **args) -> None:
        self._req_event("b", rid, f"request {rid}", t, args or None)

    def request_instant(self, rid: int, name: str, t: float, **args) -> None:
        self._req_event("n", rid, name, t, args or None)

    def request_end(self, rid: int, t: float, **args) -> None:
        self._req_event("e", rid, f"request {rid}", t, args or None)

    # -- export -------------------------------------------------------------
    def _metadata(self) -> list[dict]:
        meta = [{"name": "process_name", "ph": "M", "ts": 0.0,
                 "pid": self.pid, "tid": 0,
                 "args": {"name": self.process_name}}]
        tracks = dict(PHASE_TRACKS)
        tracks["requests"] = REQUEST_TRACK
        for name, tid in tracks.items():
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": self.pid, "tid": tid,
                         "args": {"name": name}})
        return meta

    def to_dict(self) -> dict:
        """Chrome trace JSON object.  Events are stably sorted by ts, so
        a B emitted before its same-ts E stays ordered."""
        return {"traceEvents": self._metadata()
                + sorted(self.events, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> dict:
        """Atomically write the trace JSON; returns the written object."""
        obj = self.to_dict()
        atomic_write_text(path, json.dumps(obj) + "\n")
        return obj


def validate_chrome_trace(trace: dict) -> dict:
    """Schema gate for an emitted trace (tests + CI smoke job).

    Checks: top-level shape, required keys per event, known phase types,
    monotonic ``ts`` over the event list, balanced B/E per (pid, tid)
    with matching names, balanced b/e per async (cat, id).  Returns
    summary stats; raises ValueError on any violation.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    known_ph = {"B", "E", "X", "C", "M", "b", "e", "n", "i"}
    last_ts = None
    open_spans: dict[tuple, list[str]] = {}    # (pid, tid) -> [names]
    open_async: dict[tuple, int] = {}          # (cat, id) -> depth
    n_spans = n_async = 0
    for i, ev in enumerate(events):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key "
                                 f"{key!r}: {ev!r}")
        ph = ev["ph"]
        if ph not in known_ph:
            raise ValueError(f"event {i} has unknown ph {ph!r}")
        if ph == "M":
            continue                           # metadata carries no timing
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i} has bad ts {ts!r}")
        if last_ts is not None and ts < last_ts:
            raise ValueError(f"event {i} ts {ts} < previous {last_ts} — "
                             f"trace is not time-sorted")
        last_ts = ts
        if ph == "B":
            open_spans.setdefault((ev["pid"], ev["tid"]), []) \
                .append(ev["name"])
            n_spans += 1
        elif ph == "E":
            stack = open_spans.get((ev["pid"], ev["tid"]))
            if not stack:
                raise ValueError(f"event {i}: E with no open B on tid "
                                 f"{ev['tid']}")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(f"event {i}: E {ev['name']!r} closes "
                                 f"B {top!r}")
        elif ph in ("b", "e", "n"):
            if "cat" not in ev or "id" not in ev:
                raise ValueError(f"event {i}: async {ph!r} needs cat + id")
            key = (ev["cat"], ev["id"])
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
                n_async += 1
            elif ph == "e":
                if open_async.get(key, 0) < 1:
                    raise ValueError(f"event {i}: async end with no open "
                                     f"begin for {key}")
                open_async[key] -= 1
            elif open_async.get(key, 0) < 1:
                raise ValueError(f"event {i}: async instant outside any "
                                 f"open span for {key}")
    dangling = [k for k, v in open_spans.items() if v]
    if dangling:
        raise ValueError(f"unbalanced B/E spans left open on {dangling}")
    dangling = [k for k, v in open_async.items() if v]
    if dangling:
        raise ValueError(f"unclosed async request spans: {dangling}")
    return {"n_events": len(events), "n_phase_spans": n_spans,
            "n_request_spans": n_async}

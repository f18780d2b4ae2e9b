"""Request admission scheduler for the continuous-batching engine.

The scheduler is duck-typed over a small request protocol — ``id``,
``prompt``, ``max_new_tokens``, ``priority``, ``out_tokens`` and the
bookkeeping slots ``_sched_seq`` / ``_charged_footprint``.  Since the v2
API split (input-only ``Request`` vs engine-internal generation state),
the engine queues its internal per-request records here, never the
caller's Request objects.

Policy:
  * priority classes — lower ``priority`` value is served first;
  * FCFS inside a class — ties break on arrival sequence, and a preempted
    request re-enters with its *original* sequence number, so it goes back
    to the head of its class rather than the tail;
  * max-tokens budgeting — admission is refused while the worst-case token
    footprint of running requests (prompt + max_new_tokens each, capped at
    ``footprint_cap`` — the engine's max_len truncation — so a long-prompt
    request is charged what it can actually consume) would exceed
    ``max_tokens_in_flight``;
  * preemption — under cache pressure the engine asks for a victim: the
    request with the largest resident cache footprint (tokens in cache,
    ``len(r.context())``) in the lowest priority class, which frees the
    most blocks per preemption.  Footprint, not generated-token count: a
    long-prompt request mid-prefill has zero output tokens but may hold
    more blocks than any decoding request.

Telemetry: ``stats`` is a live dict of scheduler-level counters
(submitted / admitted / budget_refusals / preemptions / released).  The
engine hands the dict to ``ServingMetrics`` once at construction, so the
summary's ``scheduler`` section and the Prometheus/JSONL exporters stay
current without a per-step push.  ``budget_refusals`` in particular is an
adaptive-scheduler input: it counts admission attempts blocked by the
token budget while work was queued — the signal that the budget, not the
cache, is the bottleneck.
"""
from __future__ import annotations

import heapq
from typing import Optional


class RequestScheduler:
    def __init__(self, *, max_tokens_in_flight: Optional[int] = None,
                 footprint_cap: Optional[int] = None):
        self.max_tokens_in_flight = max_tokens_in_flight
        self.footprint_cap = footprint_cap     # engine sets this to max_len
        self._heap: list = []                  # (priority, seq, Request)
        # plain int, not itertools.count: snapshotable (state_dict) and
        # bounded by #unique submits (preemption re-enqueue keeps its seq)
        self._next_seq = 0
        self._in_flight_tokens = 0
        # live telemetry counters (ServingMetrics holds a reference)
        self.stats: dict[str, int] = {"submitted": 0, "admitted": 0,
                                      "budget_refusals": 0,
                                      "preemptions": 0, "released": 0}

    # -- queue --------------------------------------------------------------
    def check_submittable(self, req) -> None:
        """Raise if ``req`` could NEVER be admitted (footprint over the
        whole budget) — pure check, no state change, so the engine can vet
        a batch before enqueueing any of it."""
        if (self.max_tokens_in_flight is not None
                and self._footprint(req) > self.max_tokens_in_flight):
            raise ValueError(f"request {req.id} exceeds the token budget "
                             f"({self._footprint(req)} > "
                             f"{self.max_tokens_in_flight}) — it could never "
                             f"be admitted")

    def submit(self, req) -> None:
        self.check_submittable(req)
        self._enqueue(req)
        self.stats["submitted"] += 1

    def _enqueue(self, req) -> None:
        if getattr(req, "_sched_seq", None) is None:
            req._sched_seq = self._next_seq    # preserved across preemption
            self._next_seq += 1
        heapq.heappush(self._heap, (req.priority, req._sched_seq, req))

    def remove(self, req) -> bool:
        """Drop a *queued* request (cancellation before admission).  True
        iff it was in the queue.  Queued requests hold no budget charge —
        that happens at admission — so removal is pure queue surgery."""
        kept = [e for e in self._heap if e[2] is not req]
        if len(kept) == len(self._heap):
            return False
        self._heap = kept
        heapq.heapify(self._heap)
        return True

    @property
    def queue_depth(self) -> int:
        return len(self._heap)

    def peek(self):
        return self._heap[0][2] if self._heap else None

    # -- admission ----------------------------------------------------------
    def _footprint(self, req) -> int:
        """Worst-case resident tokens — capped at footprint_cap because the
        engine truncates every request there (engine._target_total): an
        uncapped estimate over-charged the budget and could stall admission
        of requests the cache can in fact hold."""
        fp = len(req.prompt) + req.max_new_tokens
        return fp if self.footprint_cap is None else min(fp,
                                                         self.footprint_cap)

    def next_admission(self):
        """Pop the next request iff the token budget admits it, else None.
        (Head-of-line blocking within the budget is deliberate: skipping
        ahead would starve large requests.)"""
        if not self._heap:
            return None
        req = self._heap[0][2]
        if (self.max_tokens_in_flight is not None
                and self._in_flight_tokens + self._footprint(req)
                > self.max_tokens_in_flight):
            # queued work refused on budget, not cache: the signal that the
            # token budget is the bottleneck (telemetry, ROADMAP item 3)
            self.stats["budget_refusals"] += 1
            return None
        heapq.heappop(self._heap)
        # remember the exact charge: if footprint_cap changes while this
        # request is in flight (scheduler reused across engines), releasing
        # a re-computed footprint would leak budget forever
        req._charged_footprint = self._footprint(req)
        self._in_flight_tokens += req._charged_footprint
        self.stats["admitted"] += 1
        return req

    def on_finish(self, req) -> None:
        self._release_budget(req)
        self.stats["released"] += 1

    def _release_budget(self, req) -> None:
        charged = getattr(req, "_charged_footprint", None)
        self._in_flight_tokens -= (self._footprint(req) if charged is None
                                   else charged)
        req._charged_footprint = None

    # -- snapshot (ROADMAP item 4 groundwork; schedcheck canonicalizes
    #    exactly this structure) ---------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able snapshot of the scheduler's control state.  Queued
        requests are recorded by id (the engine owns the request objects
        and snapshots them separately); ``load_state_dict`` re-marries
        them.  The heap is stored in sorted (priority, seq) order — a
        canonical form, since heap layout is an implementation detail."""
        return {
            "max_tokens_in_flight": self.max_tokens_in_flight,
            "footprint_cap": self.footprint_cap,
            "next_seq": self._next_seq,
            "in_flight_tokens": self._in_flight_tokens,
            "queue": [[prio, seq, req.id]
                      for prio, seq, req in sorted(
                          self._heap, key=lambda e: e[:2])],
            "stats": dict(self.stats),
        }

    def load_state_dict(self, state: dict, requests_by_id: dict) -> None:
        """Restore from ``state_dict()`` output.  ``requests_by_id`` maps
        request id -> live request object for every queued entry."""
        self.max_tokens_in_flight = state["max_tokens_in_flight"]
        self.footprint_cap = state["footprint_cap"]
        self._next_seq = int(state["next_seq"])
        self._in_flight_tokens = int(state["in_flight_tokens"])
        self._heap = []
        for prio, seq, rid in state["queue"]:
            req = requests_by_id[rid]
            req._sched_seq = int(seq)
            self._heap.append((int(prio), int(seq), req))
        heapq.heapify(self._heap)
        self.stats.update({k: int(v) for k, v in state["stats"].items()})

    # -- preemption ---------------------------------------------------------
    def pick_preemption_victim(self, running: list):
        """Largest-resident-footprint request in the lowest priority class,
        or None.  len(context()) = prompt + generated = tokens in cache, so
        this frees the most blocks per preemption; ranking by generated
        tokens alone put a long-prompt mid-prefill request (0 output
        tokens, many resident blocks) last."""
        if not running:
            return None
        # len(prompt) + len(out_tokens) == len(context()) without the O(n)
        # concatenation — this runs per candidate on the pressure hot path
        return max(running, key=lambda r: (r.priority,
                                           len(r.prompt) + len(r.out_tokens),
                                           r._sched_seq))

    def preempt(self, req) -> None:
        """Return a running request to the queue (recompute-style: its
        generated tokens stay on the request and are re-prefilled).

        Only ``preemptions`` counts here: routing through on_finish() +
        submit() — as this used to — inflated both ``released`` and
        ``submitted`` by one per preemption, so the exported lifecycle
        counters overstated client submissions AND completions whenever
        the engine ran under cache pressure.  The budget charge is still
        released (the request no longer holds cache) and the request
        re-enters with its original seq (head of its priority class)."""
        self._release_budget(req)
        self._enqueue(req)
        self.stats["preemptions"] += 1

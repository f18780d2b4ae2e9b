"""schedcheck — exhaustive state-space model checking of the serving
control plane (twin of ``repro/analysis/schedcheck.py``, on the port's
``serving/scheduler.py``, ``serving/paged_cache.py`` and
``analysis/sanitizer.py``).

reprolint proves what source structure can, and the runtime sanitizer
samples whatever interleavings the chaos tests happen to hit.  This
module closes the gap: it drives the **actual implementation objects** —
``RequestScheduler`` and a host-only ``PagedKVCache`` (real allocator,
block tables, prefix index, LRU) — plus a stepless mirror of
``ContinuousBatchingEngine``'s control-plane transitions through *every*
interleaving of nondeterministic events up to the workload bound, and
asserts the full invariant battery at every reachable state.  Small
configs (2–4 requests, 4–8 blocks, block_size 2) are exhaustively
coverable in seconds; docs/INVARIANTS.md §9 documents the property set
and the covering config matrix.

Event alphabet (one hashable tuple each):

    ("submit", rid)        client submits request rid (any order)
    ("admit",)             engine admission: peek → prefix match → reserve
                           into the lowest idle slot (engine's slot choice)
    ("prefill", kind)      one chunk for the oldest prefilling request
                           (engine's min-_sched_seq choice); on the final
                           chunk the first token is sampled — kind "stop"
                           models a stop-token draw, "tok" a regular one
    ("decode", i, kind)    one decode token for slot i (kind as above);
                           enabled only when the needed block is
                           obtainable (free or LRU-evictable)
    ("preempt", i)         recompute-preemption of slot i, enabled while
                           some decoding slot cannot obtain its next
                           block.  With ``nondet_victims`` every busy slot
                           is a candidate (a strict superset of the
                           implementation's pick); otherwise exactly
                           ``pick_preemption_victim``'s choice

This is a sound *superset* of the engine's behaviors: the engine's
admit-all/prefill-one/decode-all step loop is one particular event
ordering, and the adaptive planner (ROADMAP item 3) will re-plan chunk
sizes and interleave ratios — i.e. pick different orderings from this
same alphabet — so invariants are checked against every ordering any
planner could choose.  Token values are a pure function of (rid,
absolute position) with a reserved stop id, exactly the fold_in(seed,
position) determinism contract, so recompute-preemption and prefix
re-matching behave as in the real engine.

Safety is checked at every state by reusing the sanitizer's ground-truth
cross-validation (``CacheSanitizer.check_cache``) as a pure predicate,
plus harness-level checks the sanitizer cannot see (budget accounting,
request conservation, LRU-retirement converse, length caps, prefix
re-match).  Temporal properties come from the explored graph: deadlock
(non-drained state with no enabled event) and admission livelock (a
state from which drain is unreachable).  Violations carry a shortest
event trace (BFS order), replayable deterministically via
``replay_trace`` — ``--emit-replay`` turns one into a pytest regression.

CLI conventions match reprolint's: positional config names,
``--select``, ``--format text|json|github``, exit 1 on findings.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

from repro_torch.analysis.lint import Finding, emit_findings
from repro_torch.analysis.sanitizer import CacheSanitizer, SanitizerError
from repro_torch.analysis.statespace import ExplorationResult, explore
from repro_torch.serving.paged_cache import (PagedCacheConfig,
                                             PagedKVCache, blocks_for)
from repro_torch.serving.scheduler import RequestScheduler

STOP_ID = 1          # reserved stop token (never produced by _tok)


def _tok(rid: int, pos: int) -> int:
    """Deterministic token value for request ``rid`` at absolute position
    ``pos`` — the model-checking stand-in for fold_in(seed, position):
    depends only on stable identity + position, so preemption recompute
    and prefix re-matching are bit-exact, and distinct requests diverge
    after a shared prompt prefix.  Never collides with STOP_ID."""
    return 2 + (rid * 7 + pos * 3) % 11


@dataclasses.dataclass(frozen=True)
class CheckConfig:
    """One bounded workload + engine geometry to exhaust."""
    name: str
    # (rid, prompt tuple, max_new_tokens, priority) per request
    requests: tuple
    slots: int
    block_size: int
    num_blocks: int            # incl. the reserved null block
    max_len: int
    prefill_chunk: int
    max_tokens_in_flight: Optional[int] = None
    share_prefix: bool = False
    with_stop: bool = True     # enable the nondet stop-token branch
    nondet_victims: bool = True  # preempt any busy slot, not just the pick
    description: str = ""


#: Properties checked at every state / over the explored graph.  Keys are
#: the ``--select`` rule ids; docs/INVARIANTS.md §9 documents each.
PROPERTIES = {
    "invariant": "sanitizer cross-validation: block conservation, "
                 "refcount == #table refs + index ref, free/ref "
                 "disjointness, LRU membership, hash<->block bijection, "
                 "commit-cursor liveness, slot pos within table capacity",
    "lru-retirement": "converse LRU check: every indexed rc==1 block held "
                      "by no table must sit in the LRU (else it is "
                      "unevictable — leaks until restart)",
    "budget": "scheduler._in_flight_tokens == sum of charged footprints "
              "of running requests, and never exceeds "
              "max_tokens_in_flight",
    "conservation": "every submitted unfinished request is in exactly one "
                    "of {queue, slot}; finished requests are in neither; "
                    "no duplicates",
    "length-cap": "len(prompt) + len(out_tokens) stays under "
                  "min(prompt+max_new, max_len) until the finish event",
    "prefix-rematch": "assign_prefix returns exactly the longest cached "
                      "chain the harness recomputes independently — a "
                      "re-admitted preempted request re-matches its "
                      "retired blocks",
    "admission-stuck": "queue non-empty + all slots idle + head cannot "
                       "fit: the engine would raise 'cannot fit an empty "
                       "pool'",
    "oom-unexpected": "reserve failed although free + evictable blocks "
                      "covered the need",
    "crash": "an implementation call raised during a transition",
    "deadlock": "a non-drained state with no enabled event",
    "livelock": "a state from which drain is unreachable (some submitted "
                "request can never finish)",
}


class _Rec:
    """Minimal request record satisfying the scheduler/cache protocol —
    the harness twin of engine._ReqState (id / prompt / max_new_tokens /
    priority / out_tokens / _sched_seq / _charged_footprint /
    context())."""
    __slots__ = ("id", "prompt", "max_new_tokens", "priority", "out_tokens",
                 "_sched_seq", "_charged_footprint")

    def __init__(self, rid, prompt, max_new_tokens, priority):
        self.id = rid
        self.prompt = tuple(prompt)
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.out_tokens: list = []
        self._sched_seq = None
        self._charged_footprint = None

    def context(self) -> tuple:
        return self.prompt + tuple(self.out_tokens)


class SchedState:
    """One snapshot of the whole control plane.  ``key`` is the canonical
    dedup key: every behavior-relevant structure, including free-list and
    LRU order, but excluding monotonic telemetry counters (scheduler
    stats, prefix hit/lookup/eviction counts) — preempt/re-admit cycles
    revisit the same behavioral state with ever-growing counters, and
    including them would make the state space infinite.  Transition-level
    violation notes ARE part of the key, so a violating edge always
    produces a distinct (reported) state."""
    __slots__ = ("key", "data", "notes", "_mat")

    def __init__(self, key, data, notes=()):
        self.key = key
        self.data = data
        self.notes = tuple(notes)
        self._mat = None


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


class ControlPlaneModel:
    """The statespace.explore model over the real serving objects.

    ``sched_cls`` / ``cache_cls`` exist for mutation-injection tests:
    substituting a subclass with a seeded bug must make the checker fire.
    """

    def __init__(self, cfg: CheckConfig, *, sched_cls=RequestScheduler,
                 cache_cls=PagedKVCache):
        self.cfg = cfg
        self.sched_cls = sched_cls
        self.cache_cls = cache_cls
        self.stop_ids = frozenset({STOP_ID}) if cfg.with_stop \
            else frozenset()
        self.cache_cfg = PagedCacheConfig(
            block_size=cfg.block_size, num_blocks=cfg.num_blocks,
            max_blocks_per_seq=blocks_for(cfg.max_len, cfg.block_size),
            share_prefix=cfg.share_prefix)
        self._sanitizer = CacheSanitizer()
        self._validate_workload()

    # -- workload vetting (mirrors engine._validate) -------------------
    def _validate_workload(self) -> None:
        cfg = self.cfg
        seen = set()
        for rid, prompt, max_new, _prio in cfg.requests:
            if rid in seen:
                raise ValueError(f"duplicate request id {rid}")
            seen.add(rid)
            if not prompt:
                raise ValueError(f"request {rid} has an empty prompt")
            if max_new < 1:
                raise ValueError(f"request {rid}: max_new_tokens >= 1")
            if len(prompt) >= cfg.max_len:
                raise ValueError(f"request {rid}: prompt >= max_len")
            if blocks_for(self._target_total(prompt, max_new),
                          cfg.block_size) > cfg.num_blocks - 1:
                raise ValueError(f"request {rid} can never fit the pool")
            fp = min(len(prompt) + max_new, cfg.max_len)
            if (cfg.max_tokens_in_flight is not None
                    and fp > cfg.max_tokens_in_flight):
                raise ValueError(f"request {rid} exceeds the token budget")

    def _target_total(self, prompt, max_new) -> int:
        return min(len(prompt) + max_new, self.cfg.max_len)

    # -- snapshot <-> live objects -------------------------------------
    def initial_state(self) -> SchedState:
        sched = self.sched_cls(
            max_tokens_in_flight=self.cfg.max_tokens_in_flight,
            footprint_cap=self.cfg.max_len)
        cache = self.cache_cls.host_only(self.cache_cfg)
        recs = {rid: _Rec(rid, prompt, mx, prio)
                for rid, prompt, mx, prio in self.cfg.requests}
        slots = [None] * self.cfg.slots
        return self._snapshot(sched, cache, recs, slots,
                              submitted=set(), finished={})

    def _snapshot(self, sched, cache, recs, slots, *, submitted, finished,
                  notes=()) -> SchedState:
        data = {
            "sched": sched.state_dict(),
            "cache": cache.host_state_dict(),
            "recs": {rid: {"out": tuple(r.out_tokens),
                           "seq": r._sched_seq,
                           "charged": r._charged_footprint}
                     for rid, r in recs.items()},
            "slots": [None if s is None else tuple(s) for s in slots],
            "submitted": frozenset(submitted),
            "finished": dict(finished),
        }
        key = (
            _freeze({k: v for k, v in data["sched"].items()
                     if k != "stats"}),
            _freeze({k: v for k, v in data["cache"].items()
                     if k != "counters"}),
            _freeze(data["recs"]),
            _freeze(data["slots"]),
            tuple(sorted(data["submitted"])),
            _freeze(data["finished"]),
            tuple(notes),
        )
        return SchedState(key, data, notes)

    def _materialize(self, state: SchedState, *, fresh: bool = False):
        """Rebuild live objects from a snapshot.  Read-only callers share
        a cached materialization; ``apply`` demands a fresh one because
        it mutates."""
        if not fresh and state._mat is not None:
            return state._mat
        d = state.data
        recs = {}
        for rid, prompt, mx, prio in self.cfg.requests:
            rec = _Rec(rid, prompt, mx, prio)
            saved = d["recs"].get(rid)
            if saved is not None:
                rec.out_tokens = list(saved["out"])
                rec._sched_seq = saved["seq"]
                rec._charged_footprint = saved["charged"]
            recs[rid] = rec
        sched = self.sched_cls()
        sched.load_state_dict(d["sched"], recs)
        cache = self.cache_cls.host_only(self.cache_cfg)
        cache.load_host_state_dict(d["cache"])
        slots = [None if s is None else list(s) for s in d["slots"]]
        mat = (sched, cache, recs, slots,
               set(d["submitted"]), dict(d["finished"]))
        if not fresh:
            state._mat = mat
        return mat

    def canonical_key(self, state: SchedState):
        return state.key

    # -- event enumeration ---------------------------------------------
    def _can_reserve(self, cache, rid: int, n_tokens: int) -> bool:
        have = len(cache.tables.get(rid, ()))
        need = blocks_for(n_tokens, self.cfg.block_size) - have
        return need <= 0 or \
            need <= cache.allocator.num_free + cache.num_cached

    def _budget_admits(self, sched, req) -> bool:
        return (sched.max_tokens_in_flight is None
                or sched._in_flight_tokens + sched._footprint(req)
                <= sched.max_tokens_in_flight)

    def enabled_events(self, state: SchedState) -> list:
        sched, cache, recs, slots, submitted, finished = \
            self._materialize(state)
        evs = []
        for rid, _p, _m, _prio in self.cfg.requests:
            if rid not in submitted:
                evs.append(("submit", rid))
        head = sched.peek()
        if head is not None and any(s is None for s in slots):
            ctx = head.context()
            if cache.can_fit_request(ctx) and \
                    self._budget_admits(sched, head):
                evs.append(("admit",))
        prefilling = [s for s in slots
                      if s is not None and s[1] == "prefill"]
        if prefilling:
            s = min(prefilling, key=lambda s: recs[s[0]]._sched_seq)
            ctx = recs[s[0]].context()
            final = min(s[3] + self.cfg.prefill_chunk, len(ctx)) == len(ctx)
            evs.append(("prefill", "tok"))
            if final and self.cfg.with_stop:
                evs.append(("prefill", "stop"))
        pressure = False
        for i, s in enumerate(slots):
            if s is None or s[1] != "decode":
                continue
            if self._can_reserve(cache, s[0], s[2] + 1):
                evs.append(("decode", i, "tok"))
                if self.cfg.with_stop:
                    evs.append(("decode", i, "stop"))
            else:
                pressure = True
        if pressure:
            busy = [i for i, s in enumerate(slots) if s is not None]
            if self.cfg.nondet_victims:
                evs.extend(("preempt", i) for i in busy)
            elif busy:
                victim = sched.pick_preemption_victim(
                    [recs[slots[i][0]] for i in busy])
                vslot = next(i for i in busy
                             if slots[i][0] == victim.id)
                evs.append(("preempt", vslot))
        return evs

    # -- transitions (each mirrors one engine control-plane path) ------
    def apply(self, state: SchedState, event: tuple) -> SchedState:
        sched, cache, recs, slots, submitted, finished = \
            self._materialize(state, fresh=True)
        notes: list = []
        try:
            kind = event[0]
            if kind == "submit":
                self._apply_submit(event[1], sched, recs, submitted)
            elif kind == "admit":
                self._apply_admit(sched, cache, recs, slots, notes)
            elif kind == "prefill":
                self._apply_prefill(event[1], sched, cache, recs, slots,
                                    finished)
            elif kind == "decode":
                self._apply_decode(event[1], event[2], sched, cache, recs,
                                   slots, finished, notes)
            elif kind == "preempt":
                self._apply_preempt(event[1], sched, cache, recs, slots)
            else:
                raise ValueError(f"unknown event {event!r}")
        except Exception as e:                    # a real-code crash IS a
            notes.append(("crash",                # checkable violation
                          f"{event!r}: {type(e).__name__}: {e}"))
        return self._snapshot(sched, cache, recs, slots,
                              submitted=submitted, finished=finished,
                              notes=notes)

    def _apply_submit(self, rid, sched, recs, submitted) -> None:
        sched.submit(recs[rid])
        submitted.add(rid)

    def _expected_match_tokens(self, cache, ctx) -> int:
        """Independent recomputation of the longest cached chain covering
        a prefix of ``ctx`` (capped at len(ctx)-1 like match_prefix) —
        the ground truth for the prefix-rematch property."""
        bs = self.cfg.block_size
        limit = max(len(ctx) - 1, 0) // bs
        prev, n = None, 0
        for i in range(limit):
            prev = (prev, tuple(int(t) for t in ctx[i * bs:(i + 1) * bs]))
            if prev not in cache._hash_to_block:
                break
            n += 1
        return n * bs

    def _apply_admit(self, sched, cache, recs, slots, notes) -> None:
        slot_i = next(i for i, s in enumerate(slots) if s is None)
        st = sched.next_admission()
        if st is None:                 # budget refused (engine breaks)
            return
        ctx = st.context()
        expected = self._expected_match_tokens(cache, ctx) \
            if self.cfg.share_prefix else 0
        n_cached = cache.assign_prefix(st.id, ctx)
        if n_cached != expected:
            notes.append((
                "prefix-rematch",
                f"request {st.id}: assign_prefix matched {n_cached} tokens "
                f"but {expected} are cached along its chain "
                f"({'re-admission' if st.out_tokens else 'admission'})"))
        ok = cache.reserve(st.id, len(ctx))
        if not ok:
            notes.append(("crash",
                          f"request {st.id}: can_fit_request passed but "
                          f"reserve failed"))
        slots[slot_i] = [st.id, "prefill", n_cached, n_cached]

    def _record_token(self, rec, tok: int) -> Optional[str]:
        rec.out_tokens.append(tok)
        if tok in self.stop_ids:
            return "stop"
        if len(rec.prompt) + len(rec.out_tokens) >= \
                self._target_total(rec.prompt, rec.max_new_tokens):
            return "length"
        return None

    def _finish(self, i, reason, sched, cache, recs, slots,
                finished) -> None:
        rid = slots[i][0]
        cache.release(rid)
        sched.on_finish(recs[rid])
        slots[i] = None
        finished[rid] = reason

    def _apply_prefill(self, kind, sched, cache, recs, slots,
                       finished) -> None:
        prefilling = [i for i, s in enumerate(slots)
                      if s is not None and s[1] == "prefill"]
        i = min(prefilling, key=lambda i: recs[slots[i][0]]._sched_seq)
        rid = slots[i][0]
        rec = recs[rid]
        ctx = rec.context()
        n_new = min(self.cfg.prefill_chunk, len(ctx) - slots[i][3])
        slots[i][3] += n_new
        slots[i][2] = slots[i][3]
        cache.commit_prefix(rid, ctx, slots[i][3])
        if slots[i][3] == len(ctx):
            tok = STOP_ID if kind == "stop" else _tok(rid, len(ctx))
            reason = self._record_token(rec, tok)
            if reason is not None:
                self._finish(i, reason, sched, cache, recs, slots, finished)
            else:
                slots[i][1] = "decode"

    def _apply_decode(self, i, kind, sched, cache, recs, slots, finished,
                      notes) -> None:
        rid = slots[i][0]
        rec = recs[rid]
        if not cache.reserve(rid, slots[i][2] + 1):
            notes.append(("oom-unexpected",
                          f"slot {i} request {rid}: reserve failed though "
                          f"free + evictable covered the need"))
            return
        slots[i][2] += 1
        tok = STOP_ID if kind == "stop" \
            else _tok(rid, len(rec.prompt) + len(rec.out_tokens))
        reason = self._record_token(rec, tok)
        if self.cfg.share_prefix and \
                slots[i][2] % self.cfg.block_size == 0:
            cache.commit_prefix(rid, rec.context(), slots[i][2])
        if reason is not None:
            self._finish(i, reason, sched, cache, recs, slots, finished)

    def _apply_preempt(self, i, sched, cache, recs, slots) -> None:
        rid = slots[i][0]
        cache.release(rid)
        sched.preempt(recs[rid])
        slots[i] = None

    # -- acceptance + safety battery -----------------------------------
    def is_accepting(self, state: SchedState) -> bool:
        d = state.data
        return (len(d["finished"]) == len(self.cfg.requests)
                and len(d["submitted"]) == len(self.cfg.requests)
                and not d["sched"]["queue"]
                and all(s is None for s in d["slots"]))

    def check_safety(self, state: SchedState) -> list:
        out = list(state.notes)
        sched, cache, recs, slots, submitted, finished = \
            self._materialize(state)
        bs = self.cfg.block_size

        # 1. the sanitizer's ground-truth cross-validation, as a predicate
        try:
            self._sanitizer.check_cache(cache)
        except SanitizerError as e:
            out.append(("invariant", str(e).replace("\n", "; ")))

        # 2. converse LRU retirement: indexed + rc==1 + unheld => in LRU
        held = {b for t in cache.tables.values() for b in t}
        for b in cache._block_to_hash:
            if (cache.allocator.refcount(b) == 1 and b not in held
                    and b not in cache._lru):
                out.append(("lru-retirement",
                            f"indexed block {b} (rc=1, unheld) missing "
                            f"from the LRU — unevictable leak"))

        # 3. slot/table consistency (null-block-write mirror)
        for i, s in enumerate(slots):
            if s is None:
                continue
            rid, _st, pos, pp = s
            table = cache.tables.get(rid)
            if table is None:
                out.append(("invariant",
                            f"busy slot {i} request {rid} has no table"))
            elif pos > len(table) * bs:
                out.append(("invariant",
                            f"slot {i} pos {pos} exceeds table capacity "
                            f"{len(table) * bs} — next write hits the "
                            f"null block"))
            if pp > pos:
                out.append(("invariant",
                            f"slot {i} prefill cursor {pp} ahead of "
                            f"residency {pos}"))

        # 4. budget accounting
        running = [s[0] for s in slots if s is not None]
        expected = sum(recs[rid]._charged_footprint or 0 for rid in running)
        if sched._in_flight_tokens != expected:
            out.append(("budget",
                        f"_in_flight_tokens={sched._in_flight_tokens} but "
                        f"running requests {sorted(running)} are charged "
                        f"{expected}"))
        if (sched.max_tokens_in_flight is not None
                and sched._in_flight_tokens > sched.max_tokens_in_flight):
            out.append(("budget",
                        f"budget exceeded: {sched._in_flight_tokens} > "
                        f"{sched.max_tokens_in_flight}"))

        # 5. request conservation: no lost or duplicated request
        queue_rids = [rid for _p, _s, rid in state.data["sched"]["queue"]]
        if len(set(queue_rids)) != len(queue_rids):
            out.append(("conservation",
                        f"queue holds duplicates: {queue_rids}"))
        if len(set(running)) != len(running):
            out.append(("conservation",
                        f"slots hold duplicates: {running}"))
        for rid, _p, _m, _prio in self.cfg.requests:
            places = ((rid in queue_rids) + (rid in running)
                      + (rid in finished))
            if rid not in submitted:
                if places:
                    out.append(("conservation",
                                f"unsubmitted request {rid} present"))
            elif places != 1:
                where = [n for n, hit in
                         [("queue", rid in queue_rids),
                          ("slot", rid in running),
                          ("finished", rid in finished)] if hit]
                out.append(("conservation",
                            f"request {rid} in {places} places "
                            f"({where or 'nowhere'}) — "
                            f"{'duplicated' if places else 'lost'}"))

        # 6. length caps
        for rid, r in recs.items():
            total = len(r.prompt) + len(r.out_tokens)
            target = self._target_total(r.prompt, r.max_new_tokens)
            if rid in finished:
                if total > target:
                    out.append(("length-cap",
                                f"finished request {rid} holds {total} "
                                f"tokens > target {target}"))
            elif total >= target and rid in submitted:
                out.append(("length-cap",
                            f"request {rid} reached {total} tokens "
                            f"(target {target}) without finishing"))

        # 7. the engine's cannot-fit-an-empty-pool raise
        head = sched.peek()
        if (head is not None and all(s is None for s in slots)
                and not cache.can_fit_request(head.context())):
            out.append(("admission-stuck",
                        f"request {head.id} cannot fit an empty pool — "
                        f"the engine would raise"))
        return out

    # -- partial-order reduction ---------------------------------------
    def independent(self, state: SchedState, a: tuple, b: tuple) -> bool:
        """True only for pairs that provably commute: decode-"tok" events
        on distinct slots where neither needs a new block (stays within
        reserved capacity), neither finishes, and neither lands on a
        block boundary (whose commit_prefix touches the shared index).
        Such events mutate disjoint slot/request state only."""
        if not (a[0] == b[0] == "decode" and a[2] == b[2] == "tok"
                and a[1] != b[1]):
            return False
        _sched, cache, recs, slots, _sub, _fin = self._materialize(state)
        for ev in (a, b):
            s = slots[ev[1]]
            if s is None or s[1] != "decode":
                return False
            rid, _st, pos, _pp = s
            rec = recs[rid]
            table = cache.tables.get(rid, ())
            if pos + 1 > len(table) * self.cfg.block_size:
                return False               # needs a new block: allocator
            if (pos + 1) % self.cfg.block_size == 0:
                return False               # boundary commit: shared index
            if len(rec.prompt) + len(rec.out_tokens) + 1 >= \
                    self._target_total(rec.prompt, rec.max_new_tokens):
                return False               # would finish: scheduler/cache
        return True


# ---------------------------------------------------------------------
# replay: a violation trace re-executed deterministically
# ---------------------------------------------------------------------

def replay_trace(cfg: CheckConfig, trace, *, model: Optional[
        ControlPlaneModel] = None):
    """Re-execute ``trace`` from the initial state.  Returns
    ``(final_state, violations)`` where violations is every (step index,
    rule, message) the safety battery reports along the way — a
    counterexample emitted by the checker reproduces its violation here,
    which is what turns traces into deterministic pytest regressions."""
    model = model if model is not None else ControlPlaneModel(cfg)
    state = model.initial_state()
    violations = [(0, kind, msg) for kind, msg in model.check_safety(state)]
    for n, event in enumerate(trace, start=1):
        state = model.apply(state, event)
        violations.extend((n, kind, msg)
                          for kind, msg in model.check_safety(state))
    return state, violations


_REPLAY_TEMPLATE = '''\
"""Auto-generated schedcheck regression (python -m repro_torch.analysis.schedcheck
--emit-replay).  Replays a minimized counterexample trace and asserts the
violation still reproduces — commit next to the fix."""
from repro_torch.analysis.schedcheck import CheckConfig, replay_trace

CONFIG = {config!r}

TRACE = {trace!r}

EXPECT_RULE = {rule!r}


def test_replayed_trace_reproduces_violation():
    _state, violations = replay_trace(CONFIG, TRACE)
    assert any(rule == EXPECT_RULE for _n, rule, _m in violations), (
        "trace no longer reproduces a %s violation: %r"
        % (EXPECT_RULE, violations))
'''


def emit_replay(path: str, cfg: CheckConfig, violation) -> None:
    """Write a standalone pytest regression for ``violation``."""
    src = _REPLAY_TEMPLATE.format(config=cfg, trace=list(violation.trace),
                                  rule=violation.kind)
    with open(path, "w") as f:
        f.write(src)


# ---------------------------------------------------------------------
# bounded config matrix (the CI gate exhausts every entry)
# ---------------------------------------------------------------------

CONFIGS: dict[str, CheckConfig] = {c.name: c for c in [
    CheckConfig(
        name="fcfs-tight",
        description="2 FCFS requests on a pool that cannot hold both "
                    "(forced decode-OOM preemption, nondet victims, "
                    "stop branches)",
        requests=((1, (3, 4), 4, 0), (2, (5, 6), 4, 0)),
        slots=2, block_size=2, num_blocks=5, max_len=8, prefill_chunk=2,
        max_tokens_in_flight=12, share_prefix=False,
        with_stop=True, nondet_victims=True),
    CheckConfig(
        name="priority-prefix",
        description="3 requests in 2 priority classes sharing a prompt "
                    "block; prefix index + LRU retirement + budget "
                    "refusals, impl victim pick",
        requests=((1, (5, 6, 7), 2, 0), (2, (5, 6, 8), 2, 1),
                  (3, (5, 6, 7), 2, 1)),
        slots=2, block_size=2, num_blocks=7, max_len=8, prefill_chunk=4,
        max_tokens_in_flight=10, share_prefix=True,
        with_stop=False, nondet_victims=False),
    CheckConfig(
        name="preempt-rematch",
        description="2 identical-prompt prefix-sharing requests on a "
                    "tight pool: preemption retires committed blocks and "
                    "re-admission must re-match them (nondet victims)",
        requests=((1, (9, 9), 4, 0), (2, (9, 9), 4, 0)),
        slots=2, block_size=2, num_blocks=5, max_len=8, prefill_chunk=2,
        max_tokens_in_flight=None, share_prefix=True,
        with_stop=False, nondet_victims=True),
    CheckConfig(
        name="wide-block",
        description="2 requests on block_size 4: mid-block decodes on "
                    "distinct slots provably commute, so sleep-set "
                    "partial-order pruning engages",
        requests=((1, (3, 4), 4, 0), (2, (5, 6), 4, 0)),
        slots=2, block_size=4, num_blocks=5, max_len=8, prefill_chunk=4,
        max_tokens_in_flight=None, share_prefix=False,
        with_stop=False, nondet_victims=True),
    CheckConfig(
        name="ample-stop",
        description="3 FCFS requests with headroom (no preemption "
                    "reachable): budget refusals + stop/length branches "
                    "only",
        requests=((1, (3, 4), 2, 0), (2, (5, 6), 2, 0), (3, (7, 8), 2, 0)),
        slots=2, block_size=2, num_blocks=9, max_len=8, prefill_chunk=4,
        max_tokens_in_flight=10, share_prefix=False,
        with_stop=True, nondet_victims=True),
]}


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

def run_config(cfg: CheckConfig, *, max_states: Optional[int] = None,
               max_depth: Optional[int] = None,
               check_liveness: bool = True, max_violations: int = 32,
               sched_cls=RequestScheduler, cache_cls=PagedKVCache,
               model: Optional[ControlPlaneModel] = None,
               ) -> ExplorationResult:
    if model is None:
        model = ControlPlaneModel(cfg, sched_cls=sched_cls,
                                  cache_cls=cache_cls)
    return explore(model, max_states=max_states, max_depth=max_depth,
                   check_liveness=check_liveness,
                   max_violations=max_violations)


def findings_from(cfg: CheckConfig, result: ExplorationResult,
                  select=None) -> list:
    findings = []
    for v in result.violations:
        if select is not None and v.kind not in select:
            continue
        trace = " -> ".join(
            ":".join(str(p) for p in e) for e in v.trace) or "<initial>"
        findings.append(Finding(
            path=f"{cfg.name}/{v.kind}", line=0, col=0, rule=v.kind,
            message=f"{v.message} | {v.depth}-event trace: {trace}"))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.schedcheck",
        description="Exhaustive state-space model checking of the serving "
                    "control plane (docs/INVARIANTS.md section 9)")
    ap.add_argument("configs", nargs="*",
                    help="config names to explore (default: all)")
    ap.add_argument("--select", default=None,
                    help="comma-separated property ids to report")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    ap.add_argument("--list-configs", action="store_true")
    ap.add_argument("--list-properties", action="store_true")
    ap.add_argument("--max-states", type=int, default=None,
                    help="truncate the search (disables liveness)")
    ap.add_argument("--depth", type=int, default=None,
                    help="bound the search depth (disables liveness)")
    ap.add_argument("--emit-replay", metavar="PATH", default=None,
                    help="write a pytest regression replaying the first "
                         "violation")
    args = ap.parse_args(argv)

    if args.list_configs:
        for cfg in CONFIGS.values():
            print(f"{cfg.name}: {cfg.description}")
        return 0
    if args.list_properties:
        for rule, desc in PROPERTIES.items():
            print(f"{rule}: {desc}")
        return 0

    select = None
    if args.select:
        select = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = select - set(PROPERTIES)
        if unknown:
            print(f"unknown properties: {sorted(unknown)}",
                  file=sys.stderr)
            return 2

    names = args.configs or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        print(f"unknown configs: {unknown} (have: {sorted(CONFIGS)})",
              file=sys.stderr)
        return 2

    all_findings = []
    total_states = 0
    for name in names:
        cfg = CONFIGS[name]
        t0 = time.perf_counter()
        result = run_config(cfg, max_states=args.max_states,
                            max_depth=args.depth)
        dt = time.perf_counter() - t0
        total_states += result.states
        cover = " ".join(f"{k}={v}"
                         for k, v in sorted(result.event_counts.items()))
        print(f"schedcheck: {name}: {result.states} states / "
              f"{result.transitions} transitions ({result.pruned} pruned) "
              f"/ {result.accepting} drained / depth {result.max_depth} / "
              f"{'fixpoint' if result.fixpoint else 'TRUNCATED'} / "
              f"{len(result.violations)} violation(s) in {dt:.2f}s "
              f"[{cover}]", file=sys.stderr)
        findings = findings_from(cfg, result, select)
        if findings and args.emit_replay and not all_findings:
            emit_replay(args.emit_replay, cfg, result.violations[0])
            print(f"schedcheck: replay regression written to "
                  f"{args.emit_replay}", file=sys.stderr)
        all_findings.extend(findings)

    emit_findings(all_findings, args.format, tool="schedcheck")
    if not all_findings:
        print(f"schedcheck: clean — {len(names)} config(s), "
              f"{total_states} states explored", file=sys.stderr)
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""Generic explicit-state bounded model checking: BFS exploration with
canonical-state dedup, shortest-counterexample reconstruction, sleep-set
partial-order pruning, and graph-level temporal checks (copy of
``repro/analysis/statespace.py``).

This module is deliberately model-agnostic — it knows nothing about
schedulers or block allocators.  A *model* is any object with:

    initial_state()            -> state
    enabled_events(state)      -> list of hashable event labels
    apply(state, event)        -> successor state (must NOT mutate state)
    canonical_key(state)       -> hashable dedup key.  Everything
                                  behavior-relevant must be in the key;
                                  monotonic telemetry counters must NOT be
                                  (or cyclic systems never reach fixpoint)
    is_accepting(state)        -> bool (e.g. "drained"): the good terminal
    check_safety(state)        -> list of (rule, message) violations
    independent(state, a, b)   -> bool, OPTIONAL: True only when a and b
                                  provably commute from ``state`` AND each
                                  stays enabled after the other

Exploration is plain breadth-first with a visited table keyed by
``canonical_key``, so the first path that discovers any state is a
shortest event sequence to it — counterexample minimization falls out of
the search order instead of needing a separate pass.

Temporal checks run on the explored graph after the search:

* **deadlock** — a non-accepting state with no enabled events (checked
  inline during the search, so a deadlock found at depth d carries a
  length-d trace).
* **livelock** — a state from which no accepting state is reachable at
  all, found by backward reachability from the accepting set.  Only
  meaningful at *fixpoint* (the search exhausted the state space rather
  than hitting a depth/state bound): on a truncated frontier a state may
  merely not have reached drain *yet*.  Sleep-set pruning can drop edges
  from the recorded graph, so every backward-unreachable candidate is
  re-confirmed by a forward search over full (unpruned) event sets before
  it is reported — the pruning stays a pure work-saver and can never
  manufacture a false livelock.

Sleep sets here are the one-step variant: when expanding a state's
events in order, the successor via event ``e_i`` is told to skip any
earlier sibling ``e_j`` (j < i) that is independent of ``e_i`` — the
commuted interleaving ``e_j . e_i`` is explored from the sibling branch
and lands on the same canonical state, so re-applying it here would only
re-derive a known state.  With full state dedup this prunes *work*, not
*reachability*: the reached state set is provably identical.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional


@dataclasses.dataclass
class Violation:
    """One property violation with its minimized witness trace."""
    kind: str                 # rule id: "deadlock" | "livelock" | safety ids
    message: str
    trace: tuple              # shortest event sequence from the initial state
    depth: int                # == len(trace)

    def format(self) -> str:
        steps = " -> ".join(repr(e) for e in self.trace) or "<initial state>"
        return f"[{self.kind}] {self.message}\n  trace ({self.depth} " \
               f"events): {steps}"


@dataclasses.dataclass
class ExplorationResult:
    states: int               # distinct canonical states discovered
    transitions: int          # edges executed (incl. ones landing on dups)
    pruned: int               # transitions skipped by sleep sets
    accepting: int            # accepting (drained) states found
    max_depth: int            # deepest state discovered
    fixpoint: bool            # True iff the full space was exhausted
    violations: list          # list[Violation], BFS order (shallowest first)
    # executed transitions per event class (a tuple event's first element)
    # — lets callers assert the model actually exercised a path (e.g.
    # "this config really preempts") instead of vacuously passing
    event_counts: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations


class _Node:
    """Visited-table entry: enough to rebuild a shortest trace."""
    __slots__ = ("state", "parent", "event", "depth", "has_events",
                 "accepting")

    def __init__(self, state, parent, event, depth):
        self.state = state
        self.parent = parent          # canonical key of the BFS parent
        self.event = event            # event that produced this state
        self.depth = depth
        self.has_events = False
        self.accepting = False


def explore(model, *, max_depth: Optional[int] = None,
            max_states: Optional[int] = None,
            check_liveness: bool = True,
            max_violations: int = 32,
            on_progress: Optional[Callable[[int], None]] = None,
            ) -> ExplorationResult:
    """Exhaustively explore ``model`` breadth-first.

    ``max_depth`` / ``max_states`` bound the search (None = unbounded:
    termination then relies on the model itself being finite-state, which
    is what the canonical key's counter-exclusion buys).  Liveness is
    checked only when the search reaches fixpoint within the bounds.
    """
    independent = getattr(model, "independent", None)
    init = model.initial_state()
    ikey = model.canonical_key(init)
    nodes: dict = {ikey: _Node(init, None, None, 0)}
    # reverse edges for backward reachability (to-key -> set of from-keys);
    # recorded for every executed transition, including duplicates
    redges: dict = {}
    queue = deque([(ikey, frozenset())])        # (key, sleep set)
    violations: list = []
    transitions = pruned = 0
    truncated = False
    event_counts: dict = {}

    def trace_to(key) -> tuple:
        ev = []
        while key is not None:
            node = nodes[key]
            if node.event is not None:
                ev.append(node.event)
            key = node.parent
        return tuple(reversed(ev))

    def report(kind: str, message: str, key) -> None:
        if len(violations) < max_violations:
            violations.append(Violation(kind, message, trace_to(key),
                                        nodes[key].depth))

    for kind, message in model.check_safety(init):
        report(kind, message, ikey)
    nodes[ikey].accepting = model.is_accepting(init)

    while queue:
        key, sleep = queue.popleft()
        node = nodes[key]
        if on_progress is not None:
            on_progress(len(nodes))
        events = model.enabled_events(node.state)
        node.has_events = bool(events)
        if not events:
            if not node.accepting:
                report("deadlock",
                       "non-drained state with no enabled event",
                       key)
            continue
        if max_depth is not None and node.depth >= max_depth:
            truncated = True
            continue
        explorable = [e for e in events if e not in sleep]
        pruned += len(events) - len(explorable)
        for i, ev in enumerate(explorable):
            child = model.apply(node.state, ev)
            ckey = model.canonical_key(child)
            transitions += 1
            cls = ev[0] if isinstance(ev, tuple) and ev else str(ev)
            event_counts[cls] = event_counts.get(cls, 0) + 1
            redges.setdefault(ckey, set()).add(key)
            if ckey in nodes:
                continue
            cnode = _Node(child, key, ev, node.depth + 1)
            nodes[ckey] = cnode
            cnode.accepting = model.is_accepting(child)
            for kind, message in model.check_safety(child):
                report(kind, message, ckey)
            if max_states is not None and len(nodes) >= max_states:
                truncated = True
                continue
            child_sleep = frozenset(
                explorable[j] for j in range(i)
                if independent is not None
                and independent(node.state, explorable[j], ev)
            ) if independent is not None else frozenset()
            queue.append((ckey, child_sleep))

    accepting = {k for k, n in nodes.items() if n.accepting}
    fixpoint = not truncated

    if check_liveness and fixpoint and not violations:
        _check_liveness(model, nodes, redges, accepting, report)

    depths = [n.depth for n in nodes.values()]
    return ExplorationResult(
        states=len(nodes), transitions=transitions, pruned=pruned,
        accepting=len(accepting), max_depth=max(depths) if depths else 0,
        fixpoint=fixpoint, violations=violations,
        event_counts=event_counts)


def _check_liveness(model, nodes, redges, accepting, report) -> None:
    """Livelock check: every state must be able to reach an accepting
    (drained) state.  Backward reachability over the recorded edge set
    finds the candidates; each is then confirmed by a forward search with
    *full* event sets, because sleep-set pruning may have skipped edges
    (never states) and a skipped edge could be a state's recorded-graph
    path to drain."""
    good = set(accepting)
    frontier = deque(good)
    while frontier:
        k = frontier.popleft()
        for pred in redges.get(k, ()):
            if pred not in good:
                good.add(pred)
                frontier.append(pred)

    candidates = [k for k, n in nodes.items() if k not in good]
    if not candidates:
        return
    candidates.sort(key=lambda k: nodes[k].depth)   # shallowest witness

    # forward confirmation with memoization; ``good`` grows as confirmed
    # escape routes are found, so later candidates reuse earlier work
    doomed: set = set()
    for cand in candidates:
        if cand in good or cand in doomed:
            continue
        seen = {cand}
        fq = deque([cand])
        escaped = False
        while fq and not escaped:
            k = fq.popleft()
            for ev in model.enabled_events(nodes[k].state):
                child = model.apply(nodes[k].state, ev)
                ckey = model.canonical_key(child)
                if ckey in good or (ckey in nodes and nodes[ckey].accepting):
                    escaped = True
                    break
                if ckey in seen or ckey in doomed:
                    continue
                seen.add(ckey)
                if ckey in nodes:            # only walk explored states
                    fq.append(ckey)
        if escaped:
            # only ``cand`` itself is proven: the forward search visited
            # sibling branches that may not share its escape route
            good.add(cand)
        else:
            doomed.update(seen)
            if nodes[cand].has_events:
                report("livelock",
                       "state can never reach drain (all continuations "
                       "cycle without finishing the submitted requests)",
                       cand)
            # has_events == False would already be a deadlock report

"""The port's schedcheck (``repro_torch.analysis.schedcheck`` on the
port's scheduler, paged cache and sanitizer): ``tests/test_schedcheck.py``
re-pointed at the port, case for case, plus the explored state spaces
held equal to the reference's, config by config.

Two halves:

* the **clean gate**: every bundled config must exhaust its state space
  (fixpoint) with zero violations, and must actually exercise the paths
  it claims to (preemption, prefix re-match, partial-order pruning) —
  coverage assertions keep the gate from passing vacuously.

* **mutation injection**: seed one known bug class at a time into the
  real scheduler / cache (or the event model) and assert the checker
  catches it with the right property id and a minimized counterexample
  that ``replay_trace`` reproduces deterministically.  This is the
  evidence that a green schedcheck run means something — each detector
  is proven live against the failure mode it exists for.
"""
import subprocess
import sys

import pytest

from repro.analysis import schedcheck as JSC
from repro_torch.analysis.schedcheck import (
    CONFIGS,
    CheckConfig,
    ControlPlaneModel,
    PROPERTIES,
    emit_replay,
    findings_from,
    main as schedcheck_main,
    replay_trace,
    run_config,
)
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.scheduler import RequestScheduler

# generous caps: a correct mutant run stays far below; a mutant that
# blows up the state space (e.g. unbounded counters) fails fast instead
# of hanging the suite
MUTANT_BOUNDS = dict(max_violations=100_000, max_states=60_000)


# ---------------------------------------------------------------------
# clean gate: the shipped matrix is exhaustive and violation-free
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_explores_clean_to_fixpoint(name):
    result = run_config(CONFIGS[name])
    assert result.fixpoint, f"{name}: state space not exhausted"
    assert result.ok, f"{name}: " + "\n".join(
        v.format() for v in result.violations)
    assert result.accepting > 0, f"{name}: no drained state reachable"
    assert result.states < 50_000, f"{name}: blow-up ({result.states})"


def test_tight_configs_actually_preempt():
    """Coverage, not correctness: the forced-preemption configs must
    execute preempt transitions or their OOM/eviction checking is
    vacuous."""
    for name in ("fcfs-tight", "preempt-rematch"):
        result = run_config(CONFIGS[name])
        assert result.event_counts.get("preempt", 0) > 0, name


def test_prefix_configs_actually_share():
    """share_prefix configs must see cache hits: a drained run of
    priority-prefix re-uses request 1's first block for requests 2/3."""
    for name in ("priority-prefix", "preempt-rematch"):
        cfg = CONFIGS[name]
        assert cfg.share_prefix
        result = run_config(cfg)
        assert result.ok and result.fixpoint, name


def test_wide_block_engages_partial_order_pruning():
    result = run_config(CONFIGS["wide-block"])
    assert result.pruned > 0, "sleep sets never pruned a transition"
    assert result.ok and result.fixpoint


def test_ample_config_reaches_stop_branches():
    result = run_config(CONFIGS["ample-stop"])
    assert result.ok and result.fixpoint
    # every event class except preempt is reachable with ample blocks
    for cls in ("submit", "admit", "prefill", "decode"):
        assert result.event_counts.get(cls, 0) > 0, cls


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_state_space_is_the_references(name):
    """The port's scheduler and cache reach the reference's state space:
    the same configs, and for each the same counts of distinct states,
    executed transitions, pruned transitions, accepting states and events
    by class."""
    assert sorted(CONFIGS) == sorted(JSC.CONFIGS)
    got, want = run_config(CONFIGS[name]), JSC.run_config(JSC.CONFIGS[name])
    assert (got.states, got.transitions, got.accepting) == \
        (want.states, want.transitions, want.accepting)
    assert (got.pruned, got.max_depth, got.fixpoint) == \
        (want.pruned, want.max_depth, want.fixpoint)
    assert got.event_counts == want.event_counts


# ---------------------------------------------------------------------
# mutation injection: each detector class proven live
# ---------------------------------------------------------------------

class EvictLeakCache(PagedKVCache):
    """Seeded bug: eviction forgets to drop the index's refcount, so the
    evicted block is deindexed but never freed — a slow leak exactly on
    the OOM edge (``_evict_for`` only runs when ``reserve`` is short)."""

    def _evict_for(self, need: int) -> None:
        while self.allocator.num_free < need and self._lru:
            b, _ = self._lru.popitem(last=False)
            key = self._block_to_hash.pop(b)
            del self._hash_to_block[key]
            # BUG: missing self.allocator.decref(b)
            self.prefix_evictions += 1


class OverchargeScheduler(RequestScheduler):
    """Seeded bug: preemption re-queues the request without releasing
    its token-budget charge, stranding budget forever."""

    def preempt(self, req) -> None:
        self._enqueue(req)
        self.stats["preemptions"] += 1


class DroppingScheduler(RequestScheduler):
    """Seeded bug: preemption releases the budget but never re-enqueues
    the request — it silently vanishes from the system."""

    def preempt(self, req) -> None:
        self._release_budget(req)
        self.stats["preemptions"] += 1


def test_detects_leaked_block_on_eviction():
    result = run_config(CONFIGS["preempt-rematch"],
                        cache_cls=EvictLeakCache, **MUTANT_BOUNDS)
    kinds = {v.kind for v in result.violations}
    assert "invariant" in kinds, kinds
    first = min((v for v in result.violations if v.kind == "invariant"),
                key=lambda v: v.depth)
    # the counterexample replays deterministically against the mutant
    model = ControlPlaneModel(CONFIGS["preempt-rematch"],
                              cache_cls=EvictLeakCache)
    _state, violations = replay_trace(CONFIGS["preempt-rematch"],
                                      first.trace, model=model)
    assert any(rule == "invariant" for _n, rule, _m in violations)
    # ...and the pristine implementation does NOT reproduce it
    _state, clean = replay_trace(CONFIGS["preempt-rematch"], first.trace)
    assert not any(rule == "invariant" for _n, rule, _m in clean)


def test_detects_budget_overcharge():
    result = run_config(CONFIGS["fcfs-tight"],
                        sched_cls=OverchargeScheduler, **MUTANT_BOUNDS)
    kinds = {v.kind for v in result.violations}
    assert "budget" in kinds, kinds
    first = min((v for v in result.violations if v.kind == "budget"),
                key=lambda v: v.depth)
    model = ControlPlaneModel(CONFIGS["fcfs-tight"],
                              sched_cls=OverchargeScheduler)
    _state, violations = replay_trace(CONFIGS["fcfs-tight"], first.trace,
                                      model=model)
    assert any(rule == "budget" for _n, rule, _m in violations)


def test_detects_lost_request():
    result = run_config(CONFIGS["fcfs-tight"],
                        sched_cls=DroppingScheduler, **MUTANT_BOUNDS)
    kinds = {v.kind for v in result.violations}
    # the dropped request violates conservation immediately and leaves
    # the system unable to drain (deadlock: nothing left to run)
    assert "conservation" in kinds, kinds
    assert "deadlock" in kinds, kinds
    first = min((v for v in result.violations
                 if v.kind == "conservation"), key=lambda v: v.depth)
    model = ControlPlaneModel(CONFIGS["fcfs-tight"],
                              sched_cls=DroppingScheduler)
    _state, violations = replay_trace(CONFIGS["fcfs-tight"], first.trace,
                                      model=model)
    assert any(rule == "conservation" for _n, rule, _m in violations)


LIVELOCK_CFG = CheckConfig(
    name="livelock-handoff",
    description="test-local: 1 slot, ample blocks, naive-fairness mutant",
    requests=((1, (3, 4), 2, 0), (2, (5, 6), 2, 0)),
    slots=1, block_size=2, num_blocks=9, max_len=8, prefill_chunk=4,
    max_tokens_in_flight=None, share_prefix=False,
    with_stop=False, nondet_victims=True)


class HandoffModel(ControlPlaneModel):
    """Seeded bug at the policy level: whenever work is queued and a
    slot is busy, the engine preempts instead of making progress — a
    naive immediate-handoff 'fairness' rule.  With one slot and two
    requests this is a finite admit/preempt ping-pong that never
    drains: the textbook admission livelock."""

    def enabled_events(self, state):
        events = super().enabled_events(state)
        sched = self._materialize(state)[0]
        busy = [i for i, s in enumerate(state.data["slots"])
                if s is not None]
        if sched.queue_depth > 0 and busy:
            events = [e for e in events
                      if e[0] not in ("prefill", "decode")]
            for i in busy:
                if ("preempt", i) not in events:
                    events.append(("preempt", i))
        return events


def test_detects_admission_livelock():
    result = run_config(LIVELOCK_CFG, model=HandoffModel(LIVELOCK_CFG),
                        **MUTANT_BOUNDS)
    assert result.fixpoint          # liveness is only checked at fixpoint
    kinds = {v.kind for v in result.violations}
    assert "livelock" in kinds, kinds
    # the witness is minimal: two submits put the system into the trap
    first = min((v for v in result.violations if v.kind == "livelock"),
                key=lambda v: v.depth)
    assert first.depth <= 4, first.trace


# ---------------------------------------------------------------------
# replay harness round trip
# ---------------------------------------------------------------------

def test_emit_replay_writes_runnable_regression(tmp_path):
    result = run_config(CONFIGS["preempt-rematch"],
                        cache_cls=EvictLeakCache, **MUTANT_BOUNDS)
    first = min((v for v in result.violations if v.kind == "invariant"),
                key=lambda v: v.depth)
    path = tmp_path / "test_replay_regression.py"
    emit_replay(str(path), CONFIGS["preempt-rematch"], first)
    src = path.read_text()
    assert "replay_trace" in src and "EXPECT_RULE = 'invariant'" in src
    # the generated module is valid, importable pytest code
    compile(src, str(path), "exec")
    # NOTE: running it would *fail* here — the seeded bug is not in the
    # shipped cache — which is exactly the point: emitted regressions
    # pin the violation until the fix lands, then keep it fixed.
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", str(path)],
        capture_output=True, text=True)
    assert proc.returncode != 0
    assert "no longer reproduces" in proc.stdout


def test_replay_on_clean_traces_is_silent():
    """Any trace the clean model can actually execute replays without a
    single safety report."""
    model = ControlPlaneModel(CONFIGS["ample-stop"])
    state = model.initial_state()
    trace = []
    for _ in range(12):
        events = model.enabled_events(state)
        if not events:
            break
        trace.append(events[0])
        state = model.apply(state, events[0])
    _state, violations = replay_trace(CONFIGS["ample-stop"], tuple(trace))
    assert violations == []


# ---------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------

def test_cli_clean_run_exits_zero(capsys):
    assert schedcheck_main(["wide-block"]) == 0
    err = capsys.readouterr().err
    assert "fixpoint" in err and "schedcheck: clean" in err


def test_cli_unknown_config_and_property_exit_two(capsys):
    assert schedcheck_main(["no-such-config"]) == 2
    assert schedcheck_main(["--select", "no-such-prop"]) == 2


def test_cli_list_flags(capsys):
    assert schedcheck_main(["--list-configs"]) == 0
    out = capsys.readouterr().out
    for name in CONFIGS:
        assert name in out
    assert schedcheck_main(["--list-properties"]) == 0
    out = capsys.readouterr().out
    for rule in PROPERTIES:
        assert rule in out


def test_cli_truncated_run_reports_not_fixpoint(capsys):
    assert schedcheck_main(["--max-states", "10", "wide-block"]) == 0
    assert "TRUNCATED" in capsys.readouterr().err


def test_findings_have_lint_shape():
    result = run_config(CONFIGS["fcfs-tight"],
                        sched_cls=DroppingScheduler, **MUTANT_BOUNDS)
    findings = findings_from(CONFIGS["fcfs-tight"], result)
    assert findings
    f = findings[0]
    assert f.path.startswith("fcfs-tight/") and f.rule in PROPERTIES
    assert "trace" in f.message
    only = findings_from(CONFIGS["fcfs-tight"], result,
                         select={"conservation"})
    assert only and all(f.rule == "conservation" for f in only)


# ---------------------------------------------------------------------
# unified front-end: python -m repro_torch.analysis
# ---------------------------------------------------------------------

from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402


def test_front_end_routes_select_to_owning_tool(capsys):
    # "no-bare-assert" is a lint rule; "budget" is a schedcheck property
    rc = analysis_main(["lint", "schedcheck",
                        "--select", "no-bare-assert,budget"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "lint: clean" in err and "schedcheck: clean" in err


def test_front_end_rejects_unowned_check(capsys):
    assert analysis_main(["lint", "--select", "not-a-check"]) == 2
    assert "no tool owns" in capsys.readouterr().err


def test_front_end_rejects_unknown_tool(capsys):
    assert analysis_main(["lintcheck"]) == 2
    assert "unknown tool" in capsys.readouterr().err


def test_front_end_refuses_tracecheck_by_name(capsys, monkeypatch):
    """tracecheck runs the steps on ``--device`` (CUDA by default).
    Without a card, naming it — or selecting one of its analyzers — is a
    usage error that names ``--device cpu``; with no tool named it is
    skipped with a note, as the reference skips a tool it cannot import.
    With ``--device cpu`` the front end routes tracecheck and its ids."""
    import torch

    from repro_torch.analysis import tracecheck
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert analysis_main(["tracecheck"]) == 2
    err = capsys.readouterr().err
    assert "'tracecheck' unavailable" in err and "--device cpu" in err
    assert analysis_main(["lint", "tracecheck"]) == 2
    assert analysis_main(["--select", "donation"]) == 2
    capsys.readouterr()
    assert analysis_main(["--select", "no-bare-assert"]) == 0
    err = capsys.readouterr().err
    assert "skipping tracecheck" in err and "--device cpu" in err
    assert "lint: clean" in err

    calls = []
    monkeypatch.setattr(tracecheck, "run_analyzers",
                        lambda archs, select, device: calls.append(
                            (archs, select, device)) or [])
    assert analysis_main(["tracecheck", "--device", "cpu", "--select",
                          "donation,sharding"]) == 0
    assert calls == [(None, {"donation", "sharding"}, "cpu")]
    assert "tracecheck: clean" in capsys.readouterr().err
    assert analysis_main(["--device", "cpu", "--select",
                          "cost-drift,no-bare-assert"]) == 0
    assert calls[-1] == (None, {"cost-drift"}, "cpu")
    assert analysis_main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for name in tracecheck.ANALYZERS:
        assert f"tracecheck:{name}" in out


def test_front_end_lists_tools_and_checks(capsys):
    assert analysis_main(["--list-tools"]) == 0
    out = capsys.readouterr().out
    for tool in ("lint", "tracecheck", "schedcheck"):
        assert tool in out
    assert analysis_main(["lint", "schedcheck", "--list-checks"]) == 0
    out = capsys.readouterr().out
    assert "lint:no-bare-assert" in out
    assert "schedcheck:livelock" in out


def test_front_end_json_is_one_document(tmp_path, capsys):
    import json as _json
    bad = tmp_path / "serving" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    rc = analysis_main(["lint", "--format", "json",
                        "--lint-paths", str(bad)])
    assert rc == 1
    doc = _json.loads(capsys.readouterr().out)
    assert doc and doc[0]["tool"] == "lint"
    assert doc[0]["rule"] == "no-bare-assert"

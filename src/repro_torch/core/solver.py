"""ASA strategy optimizer — paper §III-C / Algorithm 1 line 8 (copy of
``repro/core/solver.py``).

    min_{s_i}  Σ_i ( t_comp(c_i, s_i) + t_comm(c_i, s_i) )
    s.t.       Σ_i mem(c_i, s_i) ≤ M_j  per device

Solvers:
  * exhaustive  — exact, for |C| ≤ exhaustive_limit (tests/validation)
  * greedy      — per-component argmin, then knapsack-style repair toward
                  feasibility by the best Δmem/Δtime switch (production)

Invariant (property-tested): the returned assignment is memory-feasible when
any feasible assignment exists, and its cost ≤ every *uniform static*
strategy's cost under the same model — i.e. adaptive dominates static, the
paper's headline claim.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.core.components import Component
from repro_torch.core.costmodel import CostModel
from repro_torch.core.strategy import ALL_STRATEGIES, UNIFORM_STRATEGIES, Strategy


@dataclasses.dataclass
class Plan:
    assignment: dict[str, Strategy]
    cost: dict                     # assignment_cost() report
    feasible: bool
    method: str


def _mem_of(cm: CostModel, comps, assignment) -> float:
    return cm.assignment_cost(comps, assignment)["mem_per_device"]


def solve_uniform(cm: CostModel, comps: list[Component],
                  strategy: Strategy) -> Plan:
    """Static baseline: one strategy for every component."""
    assignment = {c.name: strategy for c in comps}
    cost = cm.assignment_cost(comps, assignment, uniform=True)
    return Plan(assignment, cost,
                cost["mem_per_device"] <= cm.hw.hbm_bytes, f"uniform-{strategy}")


def solve_exhaustive(cm: CostModel, comps: list[Component],
                     mem_limit: Optional[float] = None) -> Plan:
    M = mem_limit if mem_limit is not None else cm.hw.hbm_bytes
    best, best_cost = None, None
    for combo in itertools.product(ALL_STRATEGIES, repeat=len(comps)):
        assignment = {c.name: s for c, s in zip(comps, combo)}
        cost = cm.assignment_cost(comps, assignment)
        if cost["mem_per_device"] > M:
            continue
        if best_cost is None or cost["time"] < best_cost["time"]:
            best, best_cost = assignment, cost
    if best is None:   # nothing feasible: fall back to min-memory assignment
        assignment = {c.name: Strategy.HP for c in comps}
        return Plan(assignment, cm.assignment_cost(comps, assignment),
                    False, "exhaustive-infeasible")
    return Plan(best, best_cost, True, "exhaustive")


def solve_greedy(cm: CostModel, comps: list[Component],
                 mem_limit: Optional[float] = None) -> Plan:
    """Per-component argmin + memory repair (production path).

    Repair loop: while over the memory budget, apply the single
    component-strategy switch with the smallest Δtime per byte saved.
    """
    M = mem_limit if mem_limit is not None else cm.hw.hbm_bytes
    per = {}
    for c in comps:
        per[c.name] = {s: cm.component_cost(c, s) for s in ALL_STRATEGIES}
    assignment = {c.name: min(per[c.name], key=lambda s: per[c.name][s].time)
                  for c in comps}

    def total_mem():
        return sum(per[c.name][assignment[c.name]].mem_params
                   + per[c.name][assignment[c.name]].mem_act for c in comps)

    guard = 0
    while total_mem() > M and guard < 10 * len(comps):
        guard += 1
        best_switch, best_ratio = None, None
        for c in comps:
            cur = per[c.name][assignment[c.name]]
            cur_mem = cur.mem_params + cur.mem_act
            for s in ALL_STRATEGIES:
                if s == assignment[c.name]:
                    continue
                cand = per[c.name][s]
                saved = cur_mem - (cand.mem_params + cand.mem_act)
                if saved <= 0:
                    continue
                dt = cand.time - cur.time
                ratio = dt / saved
                if best_ratio is None or ratio < best_ratio:
                    best_ratio, best_switch = ratio, (c.name, s)
        if best_switch is None:
            break   # no memory-saving switch remains
        assignment[best_switch[0]] = best_switch[1]

    cost = cm.assignment_cost(comps, assignment)
    return Plan(assignment, cost, cost["mem_per_device"] <= M, "greedy")


def solve(cm: CostModel, comps: list[Component],
          mem_limit: Optional[float] = None,
          exhaustive_limit: int = 8) -> Plan:
    """Best of {mixed assignment, uniform DP/MP/HP} — guarantees the
    adaptive plan never loses to a static scheme under the same model."""
    M = mem_limit if mem_limit is not None else cm.hw.hbm_bytes
    if len(comps) <= exhaustive_limit:
        mixed = solve_exhaustive(cm, comps, mem_limit)
    else:
        mixed = solve_greedy(cm, comps, mem_limit)
    candidates = [mixed]
    for s in UNIFORM_STRATEGIES:      # FS participates as a uniform scheme
        if s == Strategy.FS and not cm.fs_allowed:
            continue
        u = solve_uniform(cm, comps, s)
        u = Plan(u.assignment, u.cost, u.cost["mem_per_device"] <= M, u.method)
        candidates.append(u)
    feasible = [p for p in candidates if p.feasible]
    if not feasible:
        return mixed
    return min(feasible, key=lambda p: p.cost["time"])

"""tracecheck: analysis of the port's serving steps as they run (twin of
``repro/analysis/tracecheck.py``).

reprolint (analysis.lint) checks invariants from *source* structure;
tracecheck checks the ones only visible when a step runs.  The reference
reads the lowered IR of each jitted step; the port runs eagerly, so every
registered serving step (make_paged_prefill_step / make_paged_decode_step
/ make_slot_admit_step) is run once under recorders (analysis/ircost.py)
for every registry architecture (reduced via ``configs.reduce_for_smoke``)
and five analyzers read what they saw:

  trace-cache    run a mixed serve workload (short+long prompts, greedy and
                 nucleus rows, forced preemption) through a real engine and
                 count each step's distinct argument signatures (what
                 ``jax.jit`` retraces on, and what a CUDA graph is captured
                 per) against TRACE_BUDGETS — an argument shape that leaks
                 fails here first.
  donation       every step updates the cache IN PLACE and returns it, as
                 ST.STEP_DONATION says (the port's donation): the cache
                 returned is the one passed, every pool leaf keeps its
                 storage, no op copies a pool, and no other large operand
                 rides along.
  host-transfer  no host sync inside the step (``.item()``, a device-to-
                 host copy, anything ``set_sync_debug_mode("error")``
                 stops on CUDA), and the only outputs are the sanctioned
                 per-row (B,) token/logprob vectors and the cache.
  sharding       under the (data=4, model=2) serving mesh — one process,
                 a fake process group of 8 ranks — each pool the steps
                 return is the placed engine's, placed as
                 ``core/sharding.paged_cache_specs`` declares.
  cost-drift     each step's counted FLOPs and bytes (analysis/ircost.py)
                 agree with ``core/costmodel.predict_serving_step`` within
                 the declared tolerances.

CLI mirrors reprolint::

    PYTHONPATH=src python -m repro_torch.analysis.tracecheck --device cpu
    PYTHONPATH=src python -m repro_torch.analysis.tracecheck --device cpu \\
        --arch qwen3-8b,mamba2-780m --select donation,host-transfer
    PYTHONPATH=src python -m repro_torch.analysis.tracecheck \\
        --write-bench costs.json
    PYTHONPATH=src python -m repro_torch.analysis.tracecheck \\
        --validate-bench costs.json

``--device`` defaults to CUDA, as every entry point of the port.  Exit
status 1 on any finding (the CI gate), 0 when clean.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.analysis import ircost as IC
from repro_torch.analysis.lint import Finding, emit_findings
from repro_torch.core import costmodel as CM
from repro_torch.core.costmodel import MeshShape
from repro_torch.runtime import steps as ST

# Per-step signature budgets for one drained mixed workload: chunked
# prefill pads to one shape, decode always advances the full slot batch,
# and admission resets one slot by a host index — exactly one each.
TRACE_BUDGETS = {"paged_prefill": 1, "paged_decode": 1, "slot_admit": 1}

DEFAULT_GEOM = IC.ServeGeom()

# the reference's CI serving mesh: (data 4, model 2) over 8 devices
SERVE_MESH = MeshShape(data=4, model=2)


@contextlib.contextmanager
def serve_mesh(device):
    """The (data 4, model 2) ``DeviceMesh`` on a fake process group of 8
    ranks in this process (rank 0's view: its collectives move nothing),
    destroyed on exit.  Refuses when a process group is already up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("tracecheck's sharding analyzer starts its own "
                           "fake process group of 8 ranks, and one is "
                           "already up: run it in a process of its own")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    world = SERVE_MESH.data * SERVE_MESH.model
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield init_device_mesh(dev.type, (SERVE_MESH.data, SERVE_MESH.model),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class ArchContext:
    """Everything the analyzers share for one architecture: the arch, the
    serve geometry, the device, the params, the serving mesh (None: the
    fake (4, 2) mesh, made around the sharding analyzer) and its ASA
    plan, and the memoized traces."""
    arch: object
    geom: IC.ServeGeom
    device: torch.device
    mesh: object = None
    _plan: object = None
    _params: object = None
    _placed: object = None         # (mesh, its placed StepModel)

    @classmethod
    def for_arch(cls, name: str, geom: IC.ServeGeom = DEFAULT_GEOM,
                 device=None, mesh=None) -> "ArchContext":
        from repro_torch import device as _device
        arch = configs.reduce_for_smoke(configs.get_arch(name))
        return cls(arch, geom, _device.resolve(device), mesh)

    @property
    def plan(self):
        """The plan whose ``paged_cache_specs`` the sharding analyzer
        holds the pools to."""
        if self._plan is None:
            self._plan = IC.build_plan(self.arch, self.geom,
                                       self.mesh or SERVE_MESH)
        return self._plan

    @property
    def params(self):
        if self._params is None:
            from repro_torch.models import transformer as T
            self._params = T.init_lm(self.arch, device=self.device)
        return self._params

    def kinds(self) -> tuple[str, ...]:
        return IC.step_kinds(self.arch)

    def traced(self, kind: str, *, meshful: bool = False,
               mesh=None) -> IC.TracedStep:
        """The step's trace: unplaced (memoized by ircost), or on
        ``mesh``, every kind on one placed model."""
        if not meshful:
            return IC.trace_step(self.arch, kind, self.geom,
                                 device=self.device, params=self.params)
        if self._placed is None or self._placed[0] is not mesh:
            self._placed = (mesh, IC.build_model(
                self.arch, self.geom, mesh=mesh, params=self.params))
        return IC.trace_step(self.arch, kind, self.geom, mesh=mesh,
                             model=self._placed[1])

    def finding(self, kind: str, analyzer: str, message: str) -> Finding:
        return Finding(path=f"{self.arch.name}/{kind}", line=0, col=0,
                       rule=analyzer, message=message)


# ---------------------------------------------------------------------------
# analyzer 1: trace-cache audit (runs a real engine)
# ---------------------------------------------------------------------------

def _mixed_workload(ctx: ArchContext):
    """Requests spanning the shape space that historically caused trace
    leaks: short/long prompts (different chunk counts), greedy alongside
    nucleus-sampled rows, logprobs on/off, and a block pool tight enough
    to force preemption + re-admission."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import GREEDY, SamplingParams

    arch = ctx.arch
    frontend = IC.frontend_array(arch)
    sampling = [GREEDY,
                SamplingParams(temperature=0.8, top_k=50),
                SamplingParams(temperature=1.0, top_p=0.9),
                SamplingParams(logprobs=True)]
    reqs = []
    for i, (plen, mnt) in enumerate([(3, 20), (13, 12), (9, 16), (21, 6)]):
        reqs.append(Request(
            id=i, prompt=(np.arange(plen) % arch.vocab).astype(np.int32),
            max_new_tokens=mnt, sampling=sampling[i % len(sampling)],
            frontend=frontend))
    return reqs


def audit_engine(ctx: ArchContext):
    """The trace-cache audit's engine: slots=2 with a 12-usable-block
    pool: two in-flight requests need 13 blocks at peak, so the decode
    loop must preempt and re-admit — recompute prefill re-runs the same
    padded chunk shape.  Its steps record each call's ``signature``
    (``eng.signatures[kind]``)."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(ctx.arch, ctx.params, device=ctx.device,
                                   slots=2, max_len=48, block_size=4,
                                   num_blocks=13, prefill_chunk=8)
    eng.signatures = {}

    def watch(kind, fn):
        seen = eng.signatures.setdefault(kind, set())

        def step(*args):
            seen.add(IC.signature(args))
            return fn(*args)
        return step
    eng._prefill = watch("paged_prefill", eng._prefill)
    eng._decode = watch("paged_decode", eng._decode)
    if eng._admit_slot_state is not None:
        eng._admit_slot_state = watch("slot_admit", eng._admit_slot_state)
    return eng


def check_trace_cache(ctx: ArchContext, drained=None) -> list[Finding]:
    """The audit's findings; ``drained``, when given, is called with the
    drained engine (its ``metrics`` and ``signatures``)."""
    eng = audit_engine(ctx)
    eng.generate(_mixed_workload(ctx))
    if drained is not None:
        drained(eng)
    findings = []
    for kind, seen in eng.signatures.items():
        n = len(seen)
        if n == 0:
            findings.append(ctx.finding(
                kind, "trace-cache",
                "step never executed during the audit workload — the "
                "budget check proved nothing"))
        elif n > TRACE_BUDGETS[kind]:
            findings.append(ctx.finding(
                kind, "trace-cache",
                f"called with {n} distinct trace signatures over one "
                f"drained mixed workload (budget {TRACE_BUDGETS[kind]}) — "
                f"an argument shape/dtype is leaking into the step"))
    if eng.metrics.preemptions == 0:
        findings.append(ctx.finding(
            "paged_decode", "trace-cache",
            "audit workload finished without a preemption — the tight-pool "
            "scenario no longer exercises recompute re-admission"))
    return findings


# ---------------------------------------------------------------------------
# analyzer 2: donation audit
# ---------------------------------------------------------------------------

def check_donation(ctx: ArchContext) -> list[Finding]:
    findings = []
    for kind in ctx.kinds():
        rep = IC.donation_report(ctx.traced(kind, meshful=False))
        want = ST.STEP_DONATION[kind]
        if rep["donated_args"] != want:
            findings.append(ctx.finding(
                kind, "donation",
                f"args updated in place and returned {rep['donated_args']} "
                f"!= STEP_DONATION convention {want}"))
        elif not rep["storage_kept"]:
            findings.append(ctx.finding(
                kind, "donation",
                "cache returned but its pool leaves moved to new storage "
                "— the pool is double-resident during the step"))
        for op, nbytes in rep["pool_copies"]:
            findings.append(ctx.finding(
                kind, "donation",
                f"{op} read a pool leaf and wrote {nbytes} bytes (at least "
                f"the leaf) — a copy of the pool inside the step"))
        for i, nbytes in enumerate(rep["arg_bytes"]):
            if i == 0 or i in want:        # params are read-only by design
                continue
            if nbytes >= 0.25 * rep["cache_bytes"]:
                findings.append(ctx.finding(
                    kind, "donation",
                    f"operand {i} holds {nbytes} bytes not updated in place "
                    f"(>=25% of the cache) with no convention entry"))
    return findings


# ---------------------------------------------------------------------------
# analyzer 3: host-transfer / host-sync detection
# ---------------------------------------------------------------------------

def check_host_transfer(ctx: ArchContext) -> list[Finding]:
    findings = []
    for kind in ctx.kinds():
        ts = ctx.traced(kind, meshful=False)
        syncs = IC.host_syncs(ts)
        for op, n in sorted(syncs["syncs"].items()):
            findings.append(ctx.finding(
                kind, "host-transfer",
                f"host-crossing op {op!r} ({n} call{'s' if n != 1 else ''})"
                f" inside the step — serving steps must stay "
                f"device-resident"))
        if syncs["error"]:
            findings.append(ctx.finding(
                kind, "host-transfer",
                f"the step stopped under set_sync_debug_mode('error'): "
                f"{syncs['error']}"))
            continue
        cache = ts.args[ts.cache_index]
        if kind == "slot_admit":
            if ts.out is not cache:
                findings.append(ctx.finding(
                    kind, "host-transfer",
                    "slot_admit must return exactly the cache carry"))
            continue
        B = ts.args[2].shape[0]
        outs = IC.output_structure(ts)
        ok = (isinstance(outs, tuple) and len(outs) == 3
              and all(isinstance(o, torch.Tensor)
                      and tuple(o.shape) == (B,) for o in outs[:2])
              and IC.tree_def(outs[2]) == IC.tree_def(cache))
        if not ok:
            findings.append(ctx.finding(
                kind, "host-transfer",
                f"outputs are not the sanctioned (token (B,), logprob "
                f"(B,), cache) contract (B={B}) — any extra output is an "
                f"unsanctioned device->host transfer per step"))
    return findings


# ---------------------------------------------------------------------------
# analyzer 4: sharding conformance
# ---------------------------------------------------------------------------

def check_sharding(ctx: ArchContext) -> list[Finding]:
    if ctx.mesh is not None:
        return sharding_report(ctx, ctx.mesh)[0]
    with serve_mesh(ctx.device) as mesh:
        return sharding_report(ctx, mesh)[0]


def sharding_report(ctx: ArchContext, mesh) -> tuple[list, dict]:
    """-> (findings, {kind: [(pool path, placements)]}) of every step kind
    on ``mesh``."""
    from repro_torch.core import sharding as SH
    findings, seen = [], {}
    specs = ctx.plan.paged_cache_specs()
    declared = SH.spec_leaves(specs)
    want_def = IC.tree_def(specs)
    try:
        for kind in ctx.kinds():
            got_def, got = IC.output_placements(
                ctx.traced(kind, meshful=True, mesh=mesh))
            seen[kind] = got
            if got_def != want_def:
                findings.append(ctx.finding(
                    kind, "sharding",
                    "cache output tree does not match the paged_cache_specs "
                    "tree"))
                continue
            for (path, g), spec in zip(got, declared):
                w = SH.placements(spec, mesh)
                if g is None:
                    findings.append(ctx.finding(
                        kind, "sharding",
                        f"cache pool {path} came back as a tensor the placed "
                        f"engine does not hold"))
                elif g != w:
                    findings.append(ctx.finding(
                        kind, "sharding",
                        f"cache pool {path} is placed {g} but "
                        f"core/sharding.paged_cache_specs declares {spec} "
                        f"({w})"))
    finally:
        ctx._placed = None         # the mesh may not outlive the caller
    return findings, seen


# ---------------------------------------------------------------------------
# analyzer 5: static cost extraction / drift vs core/costmodel.py
# ---------------------------------------------------------------------------

def bench_row(ctx: ArchContext, kind: str) -> dict:
    """Counted-vs-predicted cost for one (arch, step) cell — one row of
    the document ``--write-bench`` writes."""
    rep = IC.cost_report(ctx.traced(kind, meshful=False))
    batch = 1 if kind == "paged_prefill" else ctx.geom.slots
    new_tokens = ctx.geom.prefill_chunk if kind == "paged_prefill" else 1
    pred = CM.predict_serving_step(ctx.arch, batch=batch,
                                   new_tokens=new_tokens,
                                   table_len=ctx.geom.table_len)
    flops_rel_err = abs(rep["flops"] - pred["flops"]) / max(pred["flops"], 1.0)
    lo = max(min(rep["bytes"], pred["bytes"]), 1.0)
    bytes_ratio = max(rep["bytes"], pred["bytes"]) / lo
    return {
        "arch": ctx.arch.name, "step": kind,
        "batch": batch, "new_tokens": new_tokens,
        "table_len": ctx.geom.table_len,
        "flops_extracted": rep["flops"], "flops_predicted": pred["flops"],
        "flops_rel_err": round(flops_rel_err, 4),
        "bytes_extracted": rep["bytes"], "bytes_predicted": pred["bytes"],
        "bytes_ratio": round(bytes_ratio, 2),
        "temp_bytes_peak": rep["temp_bytes"],
    }


def check_cost_drift(ctx: ArchContext) -> list[Finding]:
    findings = []
    for kind in ("paged_prefill", "paged_decode"):
        row = bench_row(ctx, kind)
        if row["flops_rel_err"] > CM.SERVING_FLOPS_RTOL:
            findings.append(ctx.finding(
                kind, "cost-drift",
                f"counted {row['flops_extracted']:.3g} FLOPs vs "
                f"predicted {row['flops_predicted']:.3g} — rel err "
                f"{row['flops_rel_err']:.2f} > SERVING_FLOPS_RTOL "
                f"{CM.SERVING_FLOPS_RTOL} (costmodel.predict_serving_step "
                f"no longer models this step)"))
        if row["bytes_ratio"] > CM.SERVING_BYTES_RFACTOR:
            findings.append(ctx.finding(
                kind, "cost-drift",
                f"counted {row['bytes_extracted']:.3g} bytes vs "
                f"predicted {row['bytes_predicted']:.3g} — ratio "
                f"{row['bytes_ratio']:.1f} > SERVING_BYTES_RFACTOR "
                f"{CM.SERVING_BYTES_RFACTOR}"))
    return findings


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

ANALYZERS = {
    "trace-cache": (check_trace_cache,
                    "compile-count budgets over a drained mixed workload"),
    "donation": (check_donation,
                 "cache donated per STEP_DONATION and elided in buffers"),
    "host-transfer": (check_host_transfer,
                      "no callbacks; only (B,) token/logprob leave device"),
    "sharding": (check_sharding,
                 "cache output shardings match paged_cache_specs"),
    "cost-drift": (check_cost_drift,
                   "XLA static costs agree with costmodel predictions"),
}


def run_analyzers(arch_names: Optional[Iterable[str]] = None,
                  select: Optional[Iterable[str]] = None,
                  geom: IC.ServeGeom = DEFAULT_GEOM,
                  mesh=None, device=None) -> list[Finding]:
    names = sorted(arch_names) if arch_names else sorted(configs.ARCHS)
    chosen = [a for a in ANALYZERS if a in set(select)] if select \
        else list(ANALYZERS)
    findings: list[Finding] = []
    for name in names:
        ctx = ArchContext.for_arch(name, geom, device, mesh)
        for a in chosen:
            findings.extend(ANALYZERS[a][0](ctx))
        IC.clear()
    return sorted(findings)


# ---------------------------------------------------------------------------
# the cost document (the reference's BENCH_static_costs.json schema)
# ---------------------------------------------------------------------------

BENCH_ROW_FIELDS = ("arch", "step", "batch", "new_tokens", "table_len",
                    "flops_extracted", "flops_predicted", "flops_rel_err",
                    "bytes_extracted", "bytes_predicted", "bytes_ratio",
                    "temp_bytes_peak")


def collect_bench(arch_names: Optional[Iterable[str]] = None,
                  geom: IC.ServeGeom = DEFAULT_GEOM, device=None) -> dict:
    names = sorted(arch_names) if arch_names else sorted(configs.ARCHS)
    rows = []
    for name in names:
        ctx = ArchContext.for_arch(name, geom, device)
        for kind in ("paged_prefill", "paged_decode"):
            rows.append(bench_row(ctx, kind))
        IC.clear()
    return {
        "schema_version": 1,
        "geometry": dataclasses.asdict(geom),
        "tolerances": {"flops_rtol": CM.SERVING_FLOPS_RTOL,
                       "bytes_rfactor": CM.SERVING_BYTES_RFACTOR},
        "rows": rows,
    }


def validate_bench(doc: dict,
                   require_archs: Optional[Iterable[str]] = None) \
        -> list[str]:
    """Schema + tolerance validation of a cost document (the check that
    it is well-formed and within its own declared drift bounds).  Returns
    human-readable errors."""
    errors = []
    for key in ("schema_version", "geometry", "tolerances", "rows"):
        if key not in doc:
            errors.append(f"missing top-level key {key!r}")
    if errors:
        return errors
    tol = doc["tolerances"]
    for t in ("flops_rtol", "bytes_rfactor"):
        if not isinstance(tol.get(t), (int, float)):
            errors.append(f"tolerances.{t} missing or non-numeric")
    seen = set()
    for i, row in enumerate(doc["rows"]):
        for f in BENCH_ROW_FIELDS:
            if f not in row:
                errors.append(f"rows[{i}] missing field {f!r}")
                break
        else:
            if not all(isinstance(row[f], (int, float))
                       for f in BENCH_ROW_FIELDS[2:]):
                errors.append(f"rows[{i}] has non-numeric cost fields")
                continue
            seen.add((row["arch"], row["step"]))
            if row["flops_rel_err"] > tol.get("flops_rtol", 0):
                errors.append(
                    f"rows[{i}] ({row['arch']}/{row['step']}): "
                    f"flops_rel_err {row['flops_rel_err']} exceeds "
                    f"declared flops_rtol {tol.get('flops_rtol')}")
            if row["bytes_ratio"] > tol.get("bytes_rfactor", 0):
                errors.append(
                    f"rows[{i}] ({row['arch']}/{row['step']}): "
                    f"bytes_ratio {row['bytes_ratio']} exceeds declared "
                    f"bytes_rfactor {tol.get('bytes_rfactor')}")
    for name in (sorted(require_archs) if require_archs
                 else sorted(configs.ARCHS)):
        smoke = name + "-smoke"
        for kind in ("paged_prefill", "paged_decode"):
            if (smoke, kind) not in seen:
                errors.append(f"no row for {smoke}/{kind}")
    return errors


# ---------------------------------------------------------------------------
# CLI (mirrors reprolint)
# ---------------------------------------------------------------------------

def device_unavailable(device: Optional[str]) -> Optional[str]:
    """Why the analyzers cannot run on ``device`` here (None: they can)."""
    if torch.device(device or "cuda").type == "cuda" and \
            not torch.cuda.is_available():
        return ("no CUDA device available; pass --device cpu to run the "
                "analyzers on the host")
    return None


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.tracecheck",
        description="analysis of the port's serving steps as they run")
    ap.add_argument("--arch", default=None,
                    help="comma-separated registry arch names "
                         "(default: the whole registry)")
    ap.add_argument("--select", default=None,
                    help="comma-separated analyzer names (default: all)")
    ap.add_argument("--list-analyzers", action="store_true",
                    help="print the analyzer catalogue and exit")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "github"),
                    help="finding output format (github: workflow "
                         "annotations)")
    ap.add_argument("--write-bench", metavar="PATH", default=None,
                    help="count the steps' costs for every arch and write "
                         "the cost document to PATH")
    ap.add_argument("--validate-bench", metavar="PATH", default=None,
                    help="schema/tolerance-check a cost document and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the steps run (default: cuda; cpu runs "
                         "their plain PyTorch paths on the host)")
    args = ap.parse_args(argv)

    if args.list_analyzers:
        for name, (_, desc) in ANALYZERS.items():
            print(f"{name:16s} {desc}")
        return 0

    if args.validate_bench:
        with open(args.validate_bench) as f:
            errors = validate_bench(json.load(f))
        for e in errors:
            print(f"{args.validate_bench}: {e}")
        print(f"tracecheck: bench "
              f"{'INVALID' if errors else 'valid'} ({len(errors)} errors)")
        return 1 if errors else 0

    archs = ([a.strip() for a in args.arch.split(",") if a.strip()]
             if args.arch else None)
    for a in archs or []:
        configs.get_arch(a)            # precise unknown-arch error
    select = ({s.strip() for s in args.select.split(",") if s.strip()}
              if args.select else None)
    if select:
        unknown = select - set(ANALYZERS)
        if unknown:
            raise SystemExit(f"tracecheck: unknown analyzer(s) "
                             f"{sorted(unknown)}; see --list-analyzers")
    why = device_unavailable(args.device)
    if why:
        raise SystemExit(f"tracecheck: {why}")

    if args.write_bench:
        doc = collect_bench(archs, device=args.device)
        with open(args.write_bench, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        worst = max((r["flops_rel_err"] for r in doc["rows"]), default=0.0)
        print(f"tracecheck: wrote {len(doc['rows'])} rows to "
              f"{args.write_bench} (worst flops_rel_err {worst:.3f})")
        return 0

    findings = run_analyzers(archs, select, device=args.device)
    emit_findings(findings, args.format, tool="tracecheck")
    n = len(findings)
    if args.format == "text":
        print(f"tracecheck: {n} finding{'s' if n != 1 else ''}"
              if n else "tracecheck: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

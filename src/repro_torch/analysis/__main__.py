"""Unified analysis front-end: ``python -m repro_torch.analysis`` (twin
of ``repro/analysis/__main__.py``).

Runs the port's analysis layers — reprolint (AST), tracecheck (the
serving steps as they run) and schedcheck (control-plane state space) —
under one CLI with the shared conventions the individual tools follow:

* ``--select`` takes a comma-separated list of check ids; each id is
  routed to whichever tool owns it (lint rule / tracecheck analyzer /
  schedcheck property), and an id no tool recognizes is a usage error;
* ``--format text|json|github`` — text and github stream per-tool, json
  is one combined array over the whole run (each entry tagged with its
  originating tool) so stdout stays a single valid JSON document;
* exit 0 clean, 1 on any finding, 2 on usage error.

Tool selection: positional names restrict the run (``python -m
repro_torch.analysis lint schedcheck``).  With no names, every tool runs —
except that a tool that cannot run here (tracecheck runs the steps on
``--device``, CUDA unless ``--device cpu`` is given, and this machine may
have no card) is *skipped with a note*, the reference's rule for a tool
whose imports are missing.  Naming a tool, or selecting a check it owns,
makes that fatal again.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from repro_torch.analysis.lint import emit_findings


def _lint_catalogue() -> dict:
    from repro_torch.analysis.rules import all_rules
    return {r.name: r.description for r in all_rules()}


def _lint_run(select, args) -> list:
    from repro_torch.analysis.lint import Linter
    return Linter(select=select or None).lint_paths(args.lint_paths)


def _tracecheck_catalogue() -> dict:
    from repro_torch.analysis.tracecheck import ANALYZERS
    return {name: desc for name, (_, desc) in ANALYZERS.items()}


def _tracecheck_run(select, args) -> list:
    from repro_torch.analysis.tracecheck import run_analyzers
    return run_analyzers(None, select or None, device=args.device)


def _tracecheck_unavailable(args):
    from repro_torch.analysis.tracecheck import device_unavailable
    return device_unavailable(args.device)


def _schedcheck_catalogue() -> dict:
    from repro_torch.analysis.schedcheck import PROPERTIES
    return dict(PROPERTIES)


def _schedcheck_run(select, args) -> list:
    from repro_torch.analysis.schedcheck import (CONFIGS, findings_from,
                                                 run_config)
    findings = []
    for cfg in CONFIGS.values():
        result = run_config(cfg)
        print(f"schedcheck: {cfg.name}: {result.states} states / "
              f"{'fixpoint' if result.fixpoint else 'TRUNCATED'} / "
              f"{len(result.violations)} violation(s)", file=sys.stderr)
        findings.extend(findings_from(cfg, result, select or None))
    return findings


# name -> (runner, catalogue, one-line description)
TOOLS = {
    "lint": (_lint_run, _lint_catalogue,
             "reprolint — AST rules over the source tree (stdlib-only)"),
    "tracecheck": (_tracecheck_run, _tracecheck_catalogue,
                   "the serving steps run once under recorders "
                   "(runs them on --device)"),
    "schedcheck": (_schedcheck_run, _schedcheck_catalogue,
                   "exhaustive state-space check of the serving "
                   "control plane"),
}

# name -> why the tool cannot run here (None: it can)
UNAVAILABLE = {"tracecheck": _tracecheck_unavailable}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="run every repro_torch static-analysis layer under "
                    "one CLI")
    ap.add_argument("tools", nargs="*",
                    help=f"tools to run (default: all available): "
                         f"{', '.join(TOOLS)}; a file or directory among "
                         f"them is a lint path (``lint src/repro_torch``)")
    ap.add_argument("--select", default=None,
                    help="comma-separated check ids, routed to whichever "
                         "tool owns each id")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    ap.add_argument("--list-tools", action="store_true")
    ap.add_argument("--list-checks", action="store_true",
                    help="print every tool's check catalogue and exit")
    ap.add_argument("--lint-paths", nargs="*",
                    default=["src/repro_torch"],
                    help="paths for the lint tool (default: "
                         "src/repro_torch)")
    ap.add_argument("--device", default=None,
                    help="where tracecheck runs the steps (default: cuda; "
                         "cpu runs their plain PyTorch paths on the host)")
    args = ap.parse_args(argv)

    if args.list_tools:
        for name, (_, _, desc) in TOOLS.items():
            print(f"{name:12s} {desc}")
        return 0

    paths = [t for t in args.tools
             if t not in TOOLS and pathlib.Path(t).exists()]
    if paths:
        args.lint_paths = paths
    tools = [t for t in args.tools if t not in paths]
    explicit = bool(tools)
    names = tools or (["lint"] if paths else list(TOOLS))
    bad = [n for n in names if n not in TOOLS]
    if bad:
        print(f"analysis: unknown tool(s) {bad} (have: {list(TOOLS)})",
              file=sys.stderr)
        return 2

    # load each tool's catalogue up front: routes --select and discovers
    # which tools are importable here at all
    catalogues: dict = {}
    skipped: dict = {}
    for name in names:
        try:
            catalogues[name] = TOOLS[name][1]()
        except ImportError as e:
            if explicit:
                print(f"analysis: tool {name!r} unavailable: {e}",
                      file=sys.stderr)
                return 2
            skipped[name] = str(e)

    if args.list_checks:
        for name, cat in catalogues.items():
            for check, desc in cat.items():
                print(f"{name}:{check:22s} {desc}")
        return 0

    per_tool_select: dict = {name: None for name in catalogues}
    if args.select:
        wanted = {s.strip() for s in args.select.split(",") if s.strip()}
        routed: set = set()
        for name, cat in catalogues.items():
            mine = wanted & set(cat)
            per_tool_select[name] = mine
            routed |= mine
        unknown = wanted - routed
        if unknown:
            print(f"analysis: no tool owns check(s) {sorted(unknown)}; "
                  f"see --list-checks", file=sys.stderr)
            return 2

    # a tool that cannot run here: fatal when named or selected, else a
    # note (it keeps its catalogue: --select still routes its ids)
    for name in list(catalogues):
        why = UNAVAILABLE.get(name, lambda a: None)(args)
        if why is None:
            continue
        if explicit or per_tool_select[name]:
            print(f"analysis: tool {name!r} unavailable: {why}",
                  file=sys.stderr)
            return 2
        skipped[name] = why
        del catalogues[name]

    for name, reason in skipped.items():
        print(f"analysis: skipping {name} (unavailable: {reason})",
              file=sys.stderr)

    combined = []          # (tool, Finding) pairs for the json format
    total = 0
    for name in catalogues:
        select = per_tool_select[name]
        if args.select and not select:
            continue       # --select named nothing this tool owns
        findings = TOOLS[name][0](select, args)
        total += len(findings)
        if args.format == "json":
            combined.extend((name, f) for f in findings)
        else:
            emit_findings(findings, args.format, tool=name)
        print(f"{name}: {len(findings)} finding(s)" if findings
              else f"{name}: clean", file=sys.stderr)

    if args.format == "json":
        json.dump([{"tool": t, **dataclasses.asdict(f)}
                   for t, f in combined], sys.stdout, indent=1)
        sys.stdout.write("\n")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())

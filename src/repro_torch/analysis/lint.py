"""reprolint: a static-analysis pass enforcing the serving stack's
invariants mechanically (twin of ``repro/analysis/lint.py``, over the
port's modules)::

    PYTHONPATH=src python -m repro_torch.analysis lint src/repro_torch

The engine's correctness rests on a handful of unwritten rules — the step
functions must not sync to the host, sampling draws from explicit
generators or the counter-based threefry stream and never from a global
RNG, every allocated cache block needs an owner on every exit path,
serving files are written atomically, and the injectable engine clock is
the ONLY clock.  reprolint checks them from program structure, on every
run.

Architecture: two passes over a file set.  Pass 1 parses every
file into a :class:`ModuleInfo` (AST + import aliases + top-level
function table + per-line pragma suppressions) and registers it in a
:class:`LintContext`, so rules can resolve calls *across* analyzed
modules (the step rules follow ``T.lm_apply`` from runtime/steps.py into
models/transformer.py).  Pass 2 runs every :class:`~repro_torch.analysis.
rules.Rule` against every module and collects :class:`Finding`\\ s.

False positives are suppressed inline, never globally::

    t = time.perf_counter()  # reprolint: disable=clock-injection

Each suppression documents WHY the flagged line is the sanctioned
exception.  The CLI exits nonzero on any unsuppressed finding.

This module is stdlib-only (``ast`` + friends).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import re
import sys
from typing import Iterable, Optional

PRAGMA_RE = re.compile(r"#\s*reprolint:\s*disable=([\w\-, ]+)")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


def emit_findings(findings: list, fmt: str, *, tool: str = "reprolint",
                  stream=None) -> None:
    """Render findings in one of the CLI output formats — shared by
    reprolint and schedcheck.

    text    the classic ``path:line:col: rule: message`` lines
    json    a machine-readable array (the whole stream is valid JSON —
            summaries go to stderr, never here)
    github  GitHub Actions workflow commands: the CI jobs emit these so
            findings surface as inline PR annotations
    """
    stream = stream if stream is not None else sys.stdout
    if fmt == "json":
        json.dump([dataclasses.asdict(f) for f in findings], stream,
                  indent=1)
        stream.write("\n")
    elif fmt == "github":
        for f in findings:
            # newlines terminate a workflow command; escape per the spec
            msg = f.message.replace("%", "%25").replace("\r", "%0D") \
                           .replace("\n", "%0A")
            stream.write(f"::error file={f.path},line={f.line},"
                         f"col={f.col},title={tool}({f.rule})::{msg}\n")
    elif fmt == "text":
        for f in findings:
            stream.write(f.format() + "\n")
    else:
        raise ValueError(f"unknown findings format {fmt!r}")


class ModuleInfo:
    """Parsed view of one source file: AST, import aliases, top-level
    functions, and per-line pragma suppressions."""

    def __init__(self, path: str, source: str, modname: Optional[str] = None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.modname = modname if modname is not None else _modname_of(path)
        self.tree = ast.parse(source, filename=path)
        # alias -> dotted module it names:  "import numpy as np" -> np,
        # "from repro_torch.models import transformer as T" -> T
        self.import_aliases: dict[str, str] = {}
        # name -> (module, original name):  "from x import f as g" -> g
        self.from_imports: dict[str, tuple[str, str]] = {}
        # top-level function table for cross-module call resolution
        self.functions: dict[str, ast.FunctionDef] = {}
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.import_aliases[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        (node.module, a.name)
        # line -> set of rule names suppressed there
        self.suppressions: dict[int, set[str]] = {}
        for i, text in enumerate(self.lines, 1):
            m = PRAGMA_RE.search(text)
            if m:
                self.suppressions[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()}

    @property
    def in_serving(self) -> bool:
        """True for modules under the serving package (its cluster
        subpackage too) — the scope of the prng/atomic-write/clock/assert
        rules."""
        return "serving" in pathlib.PurePath(self.path).parts \
            or self.modname.startswith("repro_torch.serving")

    def suppressed(self, finding: Finding) -> bool:
        return finding.rule in self.suppressions.get(finding.line, set())


def _modname_of(path: str) -> str:
    """Dotted module name, anchored at the last path component named
    ``repro_torch`` (the package root under src/)."""
    parts = list(pathlib.PurePath(path).parts)
    name = parts[-1]
    if name.endswith(".py"):
        parts[-1] = name[:-3]
    if "repro_torch" in parts:
        parts = parts[len(parts) - 1 - parts[::-1].index("repro_torch"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class LintContext:
    """All modules of one lint run, keyed by dotted name — the resolver
    rules use to follow calls across analyzed files."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules: dict[str, ModuleInfo] = {m.modname: m for m in modules}

    def resolve_call(self, module: ModuleInfo, func: ast.expr) \
            -> Optional[tuple[ModuleInfo, ast.FunctionDef]]:
        """Resolve a called expression to a top-level function in an
        analyzed module: bare names via the caller's own table or its
        ``from x import f`` imports, ``alias.attr`` via import aliases.
        Returns None for anything unresolvable (builtins, methods,
        closures over parameters, externals)."""
        if isinstance(func, ast.Name):
            fn = module.functions.get(func.id)
            if fn is not None:
                return module, fn
            target = module.from_imports.get(func.id)
            if target is not None:
                mod = self.modules.get(target[0])
                if mod is not None and target[1] in mod.functions:
                    return mod, mod.functions[target[1]]
        elif isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name):
            base = func.value.id
            dotted = module.import_aliases.get(base)
            if dotted is None and base in module.from_imports:
                # "from repro_torch.models import transformer as T" parses as a
                # from-import whose value is itself a module
                fmod, orig = module.from_imports[base]
                dotted = f"{fmod}.{orig}"
            if dotted is not None:
                mod = self.modules.get(dotted)
                if mod is not None and func.attr in mod.functions:
                    return mod, mod.functions[func.attr]
        return None


class Linter:
    """Two passes: parse every file, then run every rule."""

    def __init__(self, select: Optional[set[str]] = None):
        from repro_torch.analysis.rules import all_rules
        self.rules = [r for r in all_rules()
                      if select is None or r.name in select]

    def lint_modules(self, modules: list[ModuleInfo]) -> list[Finding]:
        ctx = LintContext(modules)
        by_path = {m.path: m for m in modules}
        findings: set[Finding] = set()   # set: the step closure rules can
        for mod in modules:              # reach one callee from many roots
            for rule in self.rules:
                for f in rule.check(mod, ctx):
                    owner = by_path.get(f.path, mod)
                    if not owner.suppressed(f):
                        findings.add(f)
        return sorted(findings)

    def lint_sources(self, sources: dict[str, str]) -> list[Finding]:
        """Lint in-memory sources ({path: text}) — the fixture-corpus
        entry point the lint tests drive."""
        return self.lint_modules(
            [ModuleInfo(p, s) for p, s in sources.items()])

    def lint_paths(self, paths: list[str]) -> list[Finding]:
        modules = []
        for path in sorted(iter_python_files(paths)):
            text = pathlib.Path(path).read_text()
            try:
                modules.append(ModuleInfo(str(path), text))
            except SyntaxError as e:
                raise SystemExit(f"reprolint: cannot parse {path}: {e}")
        return self.lint_modules(modules)


def iter_python_files(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            for f in path.rglob("*.py"):
                if "__pycache__" not in f.parts:
                    yield str(f)
        elif path.suffix == ".py":
            yield str(path)
        else:
            raise SystemExit(f"reprolint: not a python file or dir: {p}")


def main(argv: Optional[list[str]] = None) -> int:
    from repro_torch.analysis.rules import all_rules
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="reprolint: serving-invariant static analysis")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule names to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "github"),
                    help="finding output format (github: workflow "
                         "annotations for inline PR review)")
    args = ap.parse_args(argv)
    if args.list_rules:
        for r in all_rules():
            print(f"{r.name:22s} {r.description}")
        return 0
    select = ({s.strip() for s in args.select.split(",") if s.strip()}
              if args.select else None)
    if select:
        known = {r.name for r in all_rules()}
        unknown = select - known
        if unknown:
            raise SystemExit(f"reprolint: unknown rule(s) "
                             f"{sorted(unknown)}; see --list-rules")
    findings = Linter(select=select).lint_paths(
        args.paths or ["src/repro_torch"])
    emit_findings(findings, args.format)
    n = len(findings)
    summary = (f"reprolint: {n} finding{'s' if n != 1 else ''}"
               if n else "reprolint: clean")
    # json output must stay parseable as a whole; github annotations keep
    # the log scannable — route the human summary to stderr there
    print(summary, file=sys.stdout if args.format == "text" else sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

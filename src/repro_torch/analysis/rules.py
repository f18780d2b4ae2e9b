"""reprolint rules: one class per enforced serving-stack invariant (twin
of ``repro/analysis/rules.py``).

The five host rules are the reference's, walking the port's modules; its
two jit rules become their eager-PyTorch analogues.  The catalogue:

  step-host-sync       no ``print`` / ``.item()`` / ``.tolist()`` /
                       ``.cpu()`` / ``.numpy()`` /
                       ``torch.cuda.synchronize`` inside the step factories'
                       step functions or anything they (transitively)
                       call — a host sync in the step makes the host wait
                       for the device every engine step.  (The
                       reference's ``jit-host-sync``.)
  step-tensor-branch   no Python ``if``/``while``/``assert`` on a *tensor
                       value* inside a step function — each one is a
                       ``bool(tensor)``, a host sync that the code does not
                       show.  Branching on ``.shape``/``.ndim``/``len()``/
                       ``is None`` is host-side and allowed.  (The
                       reference's ``jit-recompile-hazard``: eager PyTorch
                       has no trace to recompile, so what stays of it is
                       the hidden sync.)
  prng-discipline      serving code draws from explicit generators
                       (``generator=``) or the counter-based threefry
                       stream (``serving/threefry.py``: a pure function of
                       seed and position), never from a global RNG
                       (``torch.manual_seed``, ``torch.rand*`` without a
                       generator, ``numpy.random.<draw>``, the stdlib's
                       ``random``) — global state makes a draw depend on
                       whatever drew before it, so recompute-preemption
                       replays a different stream.  (The reference's rule
                       bans ``jax.random.split`` and draws on keys not
                       derived by ``fold_in``.)
  refcount-pairing     a local holding ``BlockAllocator.alloc()`` blocks
                       must, on every exit path (including exception
                       edges), either transfer ownership (stored /
                       returned / passed on) or free them.
  atomic-write         file writes under serving/ go through
                       ``serving/export.atomic_write_text``.
  clock-injection      no ambient clock (``time.time``/``perf_counter``/
                       ...) in serving/ — the injectable engine clock only.
  no-bare-assert       serving/ runtime invariants raise, never assert.

Static-analysis honesty: these are linters, not proofs.  The runtime
``analysis/sanitizer.py`` covers the dynamic remainder (e.g. incref/
decref pairing across functions, cross-validated against live block
tables every engine step).
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from repro_torch.analysis.lint import Finding, LintContext, ModuleInfo

# top-level factory functions whose nested defs are the step functions:
# the step factories (runtime/steps.py), the sampler factory, and any
# make_* factory that returns a function the engine calls every step
FACTORY_RE = re.compile(r"^make_\w*$")

# attributes and methods that read a tensor's metadata, kept on the host —
# deriving from these does NOT taint (no device value is read)
SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "itemsize"}
SHAPE_METHODS = {"size", "dim", "numel", "element_size", "stride",
                 "is_contiguous", "is_floating_point", "data_ptr"}

# builtins that only inspect a value: passing an alloc-result to these
# does not transfer ownership
INSPECTOR_FUNCS = {"len", "bool", "repr", "str", "print", "isinstance",
                   "type", "sorted", "sum", "min", "max", "any", "all",
                   "iter", "reversed", "enumerate", "id", "format", "hash"}


class Rule:
    name = ""
    description = ""

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        raise NotImplementedError

    def finding(self, module: ModuleInfo, node: ast.AST, message: str) \
            -> Finding:
        return Finding(path=module.path, line=node.lineno,
                       col=node.col_offset + 1, rule=self.name,
                       message=message)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def dotted_name(node: ast.expr, module: Optional[ModuleInfo] = None) \
        -> Optional[str]:
    """``torch.cuda.synchronize`` for an Attribute chain over Names, with the
    head alias resolved through the module's imports (``import numpy as
    np`` makes ``np.asarray`` read as ``numpy.asarray``)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    head = node.id
    if module is not None:
        if head in module.import_aliases:
            head = module.import_aliases[head]
        elif head in module.from_imports:
            fmod, orig = module.from_imports[head]
            head = f"{fmod}.{orig}"
    parts.append(head)
    return ".".join(reversed(parts))


def _nested_functions(fn: ast.FunctionDef) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(fn):
        if node is not fn and isinstance(node, (ast.FunctionDef,
                                                ast.AsyncFunctionDef)):
            yield node


def _own_statements(fn: ast.FunctionDef) -> Iterable[ast.AST]:
    """Walk a function's AST *excluding* nested function bodies (those are
    analyzed as their own scopes)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def step_roots(module: ModuleInfo) -> list[ast.FunctionDef]:
    """The step functions in ``module``: nested defs of make_* factories
    (their params are the step's tensors; the factory's own params are
    fixed when the step is built)."""
    roots: list[ast.FunctionDef] = []
    seen: set[int] = set()
    for fn in module.functions.values():
        if FACTORY_RE.match(fn.name):
            for inner in _nested_functions(fn):
                if id(inner) not in seen:
                    seen.add(id(inner))
                    roots.append(inner)
    return roots


def step_reachable(module: ModuleInfo, ctx: LintContext) \
        -> list[tuple[ModuleInfo, ast.FunctionDef, bool]]:
    """Step roots plus every analyzed function transitively reachable
    from them via resolvable calls (same-module names, imported modules in
    the fileset).  The bool marks roots (where the tensor arguments are
    known) vs transitive callees (host-sync ops only)."""
    out: list[tuple[ModuleInfo, ast.FunctionDef, bool]] = []
    visited: set[int] = set()
    queue: list[tuple[ModuleInfo, ast.FunctionDef]] = []
    for fn in step_roots(module):
        if id(fn) not in visited:
            visited.add(id(fn))
            out.append((module, fn, True))
            queue.append((module, fn))
    while queue:
        mod, fn = queue.pop()
        for node in _own_statements(fn):
            if not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve_call(mod, node.func)
            if resolved is None and isinstance(node.func, ast.Name):
                # nested helper defined in an enclosing factory scope
                for inner in _nested_functions(fn):
                    if inner.name == node.func.id:
                        resolved = (mod, inner)
                        break
            if resolved is not None and id(resolved[1]) not in visited:
                visited.add(id(resolved[1]))
                out.append((resolved[0], resolved[1], False))
                queue.append(resolved)
    return out


def host_modules(module: ModuleInfo) -> frozenset:
    """The names under which ``module`` imports numpy: a numpy function's
    result is a host array (numpy refuses a device tensor outright), so
    it carries no tensor value."""
    return frozenset(a for a, m in module.import_aliases.items()
                     if m == "numpy")


def compute_taint(fn: ast.FunctionDef, host: frozenset = frozenset()) \
        -> set:
    """Names holding tensor values inside a step function: the parameters
    plus anything assigned from an expression over them — except pure
    metadata derivations and numpy results (``host``: numpy's names),
    which stay on the host."""
    args = fn.args
    tainted: set[str] = {a.arg for a in (args.posonlyargs + args.args
                                         + args.kwonlyargs)}
    for extra in (args.vararg, args.kwarg):
        if extra is not None:
            tainted.add(extra.arg)
    for _ in range(2):                      # fixpoint for chained assigns
        for node in _own_statements(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.For):
                targets, value = [node.target], node.iter
            else:
                continue
            if expr_tainted(value, tainted, host):
                for t in targets:
                    for name in ast.walk(t):
                        if isinstance(name, ast.Name):
                            tainted.add(name.id)
    return tainted


def expr_tainted(node: ast.expr, tainted: set,
                 host: frozenset = frozenset()) -> bool:
    """Does evaluating ``node`` produce a tensor value?  Metadata
    accesses (``.shape``, ``.size()``, ...), ``len()``, ``isinstance()``,
    ``is`` / ``is not`` tests and calls into numpy (``host``) stay on the
    host and break the taint."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in SHAPE_ATTRS:
            return False
        return expr_tainted(node.value, tainted, host)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in (
                "len", "isinstance"):
            return False
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in SHAPE_METHODS:
            return False
        head = node.func
        while isinstance(head, ast.Attribute):
            head = head.value
        if isinstance(head, ast.Name) and head.id in host \
                and head is not node.func:
            return False
        parts = list(node.args) + [kw.value for kw in node.keywords]
        if isinstance(node.func, ast.Attribute):
            # method call on a tensor value (x.sum(), x.float())
            parts.append(node.func)
        return any(expr_tainted(p, tainted, host) for p in parts)
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    if isinstance(node, (ast.Constant, ast.Lambda)):
        return False
    return any(expr_tainted(child, tainted, host)
               for child in ast.iter_child_nodes(node)
               if isinstance(child, ast.expr))


# ---------------------------------------------------------------------------
# step-host-sync
# ---------------------------------------------------------------------------

class StepHostSync(Rule):
    """Host-synchronizing ops inside the step functions.

    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``torch.cuda.synchronize`` make the host wait until
    the device has finished everything queued before them: the host can
    no longer run ahead and queue the next kernels, so every engine step
    pays the device's latency on the host.  ``print`` of a tensor does
    the same.  Checked for the step roots AND everything they
    transitively call within the analyzed fileset (runtime/steps.py pulls
    in the model stack).  ``float()/int()/bool()`` on tensor values are
    flagged in roots, where the tensor arguments are known.  The
    reference's ``jit-host-sync``, for eager PyTorch: its
    ``np.asarray`` / ``jax.device_get`` have no place here (numpy refuses
    a device tensor; the way to the host is ``.cpu()`` / ``.numpy()``)."""
    name = "step-host-sync"
    description = ("no print/.item()/.tolist()/.cpu()/.numpy()/"
                   "cuda.synchronize (host syncs) in step functions or "
                   "anything they call (the reference's jit-host-sync)")

    METHODS = {"item", "tolist", "cpu", "numpy"}

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        findings = []
        for mod, fn, is_root in step_reachable(module, ctx):
            host = host_modules(mod)
            taint = compute_taint(fn, host) if is_root else None
            for node in _own_statements(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = self._host_op(node, mod, taint, host)
                if f is not None:
                    where = (f"step function `{fn.name}`" if is_root else
                             f"`{fn.name}` (reached from a step function)")
                    findings.append(self.finding(
                        mod, node, f"{f} inside {where} makes the host "
                        f"wait for the device"))
        return findings

    def _host_op(self, node: ast.Call, mod: ModuleInfo,
                 taint: Optional[set], host: frozenset) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "print":
            return "print()"
        if isinstance(func, ast.Attribute) and func.attr in self.METHODS \
                and not node.args and not node.keywords:
            return f".{func.attr}()"
        dn = dotted_name(func, mod) or ""
        if dn.endswith("cuda.synchronize"):
            return "torch.cuda.synchronize()"
        if isinstance(func, ast.Name) and func.id in ("float", "int",
                                                      "bool") \
                and taint is not None and node.args \
                and expr_tainted(node.args[0], taint, host):
            return f"{func.id}() on a tensor value"
        return None


# ---------------------------------------------------------------------------
# step-tensor-branch
# ---------------------------------------------------------------------------

class StepTensorBranch(Rule):
    """Python control flow on tensor values inside a step function.

    ``if x.sum() > 0`` calls ``bool()`` on a device tensor: a host sync
    that the code does not show, once per step.  Branch with
    ``torch.where`` instead, or on host values.  Branching on
    ``.shape``/``.ndim``/``len()``/``is None`` and on the factory's own
    parameters stays on the host and is allowed.  The reference's
    ``jit-recompile-hazard``: under ``jax.jit`` such a branch recompiles
    or raises; eager PyTorch has no trace, and what stays is the sync."""
    name = "step-tensor-branch"
    description = ("no Python if/while/assert on tensor values in step "
                   "functions (a hidden bool(tensor) sync; use "
                   "torch.where) (the reference's jit-recompile-hazard)")

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        findings = []
        host = host_modules(module)
        for fn in step_roots(module):
            taint = compute_taint(fn, host)
            for node in _own_statements(fn):
                test = None
                kind = None
                if isinstance(node, (ast.If, ast.While)):
                    test, kind = node.test, type(node).__name__.lower()
                elif isinstance(node, ast.IfExp):
                    test, kind = node.test, "conditional expression"
                elif isinstance(node, ast.Assert):
                    test, kind = node.test, "assert"
                if test is not None and expr_tainted(test, taint, host):
                    findings.append(self.finding(
                        module, node,
                        f"Python `{kind}` on a tensor value in step "
                        f"function `{fn.name}` — a hidden bool(tensor) host "
                        f"sync every step; use torch.where"))
        return findings


# ---------------------------------------------------------------------------
# prng-discipline
# ---------------------------------------------------------------------------

class PrngDiscipline(Rule):
    """Serving draws come from explicit generators, never a global RNG.

    Preemption-proof determinism requires a token's sampling noise to be
    a pure function of (request seed, absolute position) — with no
    dependence on batch row, step count, or scheduling history.  The
    port's sampler draws the reference's threefry stream by position
    (``serving/threefry.py``), and anything else random in serving/ must
    name its ``generator=``: a draw from torch's, numpy's or Python's
    global RNG depends on every draw made before it in the process, and
    seeding that global state (``torch.manual_seed``) resets it for
    every other user.  The reference's rule (``fold_in`` keys, no
    ``jax.random.split``) in torch's terms."""
    name = "prng-discipline"
    description = ("serving/ draws take an explicit generator= (or the "
                   "threefry stream); no global RNG: torch.manual_seed, "
                   "torch.rand* without a generator, numpy.random.*, "
                   "random.*")

    TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
                   "bernoulli", "normal", "poisson", "rand_like",
                   "randn_like", "randint_like"}
    TENSOR_DRAWS = {"uniform_", "normal_", "exponential_", "bernoulli_",
                    "random_", "geometric_", "cauchy_", "log_normal_"}
    SEEDING = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
               "torch.random.seed", "torch.cuda.manual_seed",
               "torch.cuda.manual_seed_all", "torch.cuda.seed",
               "torch.cuda.seed_all", "torch.set_rng_state",
               "torch.cuda.set_rng_state"}
    # numpy.random names that build an explicit generator, not draw
    NUMPY_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox", "SFC64", "MT19937", "BitGenerator"}

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        if not module.in_serving:
            return []
        findings = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                what = self._global_draw(node, module)
                if what is not None:
                    findings.append(self.finding(
                        module, node,
                        f"{what} in serving/ uses a global RNG — draw from "
                        f"an explicit generator= (or the threefry stream) "
                        f"so that sampling stays a pure function of (seed, "
                        f"position) under preemption and restart"))
        return findings

    def _global_draw(self, node: ast.Call, module: ModuleInfo) \
            -> Optional[str]:
        dn = dotted_name(node.func, module) or ""
        if dn in self.SEEDING:
            return f"`{dn}`"
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        head, _, attr = dn.rpartition(".")
        if head in ("torch", "torch.random") and attr in self.TORCH_DRAWS \
                and not has_gen:
            return f"`{dn}` without a generator"
        if isinstance(node.func, ast.Attribute) and not dn.startswith(
                ("numpy.", "random.")) and \
                node.func.attr in self.TENSOR_DRAWS and not has_gen:
            return f"`.{node.func.attr}()` without a generator"
        if head == "numpy.random" and attr not in self.NUMPY_OK:
            return f"`{dn}`"
        if head == "random":
            return f"`{dn}`"
        return None


# ---------------------------------------------------------------------------
# refcount-pairing
# ---------------------------------------------------------------------------

class RefcountPairing(Rule):
    """Alloc-result ownership on every exit path.

    Tracks locals assigned from ``<allocator>.alloc(...)`` through a
    simplified per-function control-flow walk.  On every exit (return,
    raise, end of body) the blocks must have been *consumed*: stored into
    a table/field, returned, passed to a non-inspecting call (ownership
    transfer), or freed (``free``/``decref`` — including a loop over the
    list that decrefs).  Statements that can raise while blocks are
    unconsumed and no enclosing ``try`` protects them are flagged as
    exception-edge leaks.  ``if x is None: return`` after an alloc is the
    sanctioned OOM path (``alloc`` is all-or-nothing) and never flags.

    Intraprocedural by design: cross-function incref/decref pairing (the
    prefix index holding one ref per committed block, etc.) cannot be
    proven statically and is instead cross-validated at runtime by
    ``analysis/sanitizer.py`` against live block tables every step."""
    name = "refcount-pairing"
    description = ("BlockAllocator.alloc results must be stored, returned "
                   "or freed on every exit path (incl. exception edges)")

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        findings = []
        scopes = []
        for fn in module.functions.values():
            scopes.append(fn)
            scopes.extend(_nested_functions(fn))
        for cls in (n for n in ast.walk(module.tree)
                    if isinstance(n, ast.ClassDef)):
            for item in cls.body:
                if isinstance(item, ast.FunctionDef):
                    scopes.append(item)
                    scopes.extend(_nested_functions(item))
        for fn in scopes:
            findings.extend(_AllocWalker(self, module, fn).run())
        return findings


def _is_alloc_call(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr == "alloc"


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _contains_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) for n in ast.walk(node))


class _AllocWalker:
    """Simplified path walker for one function (see RefcountPairing)."""

    def __init__(self, rule: RefcountPairing, module: ModuleInfo,
                 fn: ast.FunctionDef):
        self.rule, self.module, self.fn = rule, module, fn
        self.live: dict[str, int] = {}       # name -> alloc line
        self.findings: list[Finding] = []
        self.reported: set[tuple] = set()
        self.protected = 0                   # inside try with handler/finally

    def run(self) -> list[Finding]:
        terminated = self.block(self.fn.body)
        if not terminated:
            self.leak_all(self.fn, "at the end of the function")
        return self.findings

    # -- reporting ------------------------------------------------------
    def report(self, node: ast.AST, name: str, why: str) -> None:
        key = (name, why.split(" ", 1)[0], node.lineno)
        if key in self.reported:
            return
        self.reported.add(key)
        line = self.live.get(name, node.lineno)
        self.findings.append(self.rule.finding(
            self.module, node,
            f"blocks in `{name}` (allocated line {line}) {why} — every "
            f"exit path must store, return or free an alloc result"))

    def leak_all(self, node: ast.AST, where: str) -> None:
        for name in list(self.live):
            self.report(node, name, f"leak {where}")

    # -- consumption ----------------------------------------------------
    def consume_in(self, stmt: ast.stmt) -> bool:
        """Mark tracked names consumed by this statement; True if any."""
        consumed = False
        if isinstance(stmt, ast.Assign):
            names = _names_in(stmt.value) & set(self.live)
            if names and not _is_alloc_call(stmt.value):
                # storing (table[x] = blocks / self.f = blocks) or
                # aliasing transfers ownership
                for n in names:
                    del self.live[n]
                consumed = True
        elif isinstance(stmt, ast.AugAssign):
            names = _names_in(stmt.value) & set(self.live)
            for n in names:
                del self.live[n]
            consumed = bool(names)
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            names = _names_in(stmt.value) & set(self.live)
            for n in names:
                del self.live[n]
            consumed = bool(names)
        elif isinstance(stmt, ast.Expr):
            consumed = self._consume_calls(stmt.value)
        elif isinstance(stmt, ast.For):
            # `for b in blocks: ...decref(b)/free(b)...` frees the list
            names = _names_in(stmt.iter) & set(self.live)
            if names and any(
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("decref", "free")
                    for n in ast.walk(stmt)):
                for n in names:
                    del self.live[n]
                consumed = True
        return consumed

    def _consume_calls(self, expr: ast.expr) -> bool:
        consumed = False
        for call in (n for n in ast.walk(expr) if isinstance(n, ast.Call)):
            if isinstance(call.func, ast.Name) \
                    and call.func.id in INSPECTOR_FUNCS:
                continue
            args = list(call.args) + [kw.value for kw in call.keywords]
            names = set()
            for a in args:
                names |= _names_in(a) & set(self.live)
            if names:
                for n in names:
                    del self.live[n]
                consumed = True
        return consumed

    # -- walk -----------------------------------------------------------
    def block(self, stmts: list) -> bool:
        """Process a statement list; True if the path surely terminated."""
        for stmt in stmts:
            if self.statement(stmt):
                return True
        return False

    def statement(self, stmt: ast.stmt) -> bool:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return False                       # separate scope
        consumed = self.consume_in(stmt)

        if isinstance(stmt, ast.Assign) and _is_alloc_call(stmt.value) \
                and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            self.live[stmt.targets[0].id] = stmt.lineno
            return False
        if isinstance(stmt, ast.Expr) and _is_alloc_call(stmt.value):
            self.findings.append(self.rule.finding(
                self.module, stmt,
                "alloc() result discarded — the granted blocks can never "
                "be freed"))
            return False

        if isinstance(stmt, ast.Return):
            self.leak_all(stmt, "at this return")
            return True
        if isinstance(stmt, ast.Raise):
            if not self.protected:
                self.leak_all(stmt, "through this raise")
            return True
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return True

        if isinstance(stmt, ast.If):
            return self._if(stmt)
        if isinstance(stmt, ast.Try) or (hasattr(ast, "TryStar")
                                         and isinstance(stmt, ast.TryStar)):
            return self._try(stmt)
        if isinstance(stmt, (ast.For, ast.While)):
            self.block(stmt.body)
            self.block(stmt.orelse)
            return False
        if isinstance(stmt, ast.With):
            return self.block(stmt.body)

        # exception edge: a raising call while blocks are live and no
        # try protects them
        if not consumed and self.live and not self.protected \
                and _contains_call(stmt):
            for name in list(self.live):
                self.report(stmt, name,
                            "may leak on this exception edge (the call can "
                            "raise before ownership transfers; wrap in "
                            "try/finally or free first)")
        return False

    def _none_guarded(self, test: ast.expr) -> Optional[str]:
        """`x is None` / `not x` test → the alloc-failure guard name."""
        if isinstance(test, ast.Compare) and isinstance(test.left, ast.Name) \
                and len(test.ops) == 1 \
                and isinstance(test.ops[0], (ast.Is, ast.Eq)) \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            return test.left.id
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and isinstance(test.operand, ast.Name):
            return test.operand.id
        return None

    def _if(self, stmt: ast.If) -> bool:
        guard = self._none_guarded(stmt.test)
        saved = dict(self.live)
        if guard in self.live:
            del self.live[guard]             # alloc failed: nothing granted
        body_term = self.block(stmt.body)
        body_live = self.live
        self.live = dict(saved)
        else_term = self.block(stmt.orelse) if stmt.orelse else False
        else_live = self.live
        if body_term and (else_term or not stmt.orelse):
            self.live = else_live if body_term and not else_term else {}
            if body_term and not stmt.orelse:
                self.live = else_live
            return body_term and else_term
        # a name stays live if it survives any fall-through branch
        merged: dict[str, int] = {}
        if not body_term:
            merged.update(body_live)
        if not else_term:
            merged.update(else_live)
        self.live = merged
        return False

    def _try(self, stmt) -> bool:
        protected = bool(stmt.handlers) or bool(stmt.finalbody)
        if protected:
            self.protected += 1
        term = self.block(stmt.body)
        if protected:
            self.protected -= 1
        for handler in stmt.handlers:
            saved = dict(self.live)
            self.block(handler.body)
            self.live = saved
        self.block(stmt.finalbody)
        return term and not stmt.finalbody


# ---------------------------------------------------------------------------
# atomic-write
# ---------------------------------------------------------------------------

class AtomicWrite(Rule):
    """Serving file writes route through export.atomic_write_text.

    A metrics/trace/snapshot consumer (CI validators, dashboards, the
    bench) reading a file mid-write must see either the old version or
    the complete new one — never a truncated JSON.  ``atomic_write_text``
    (temp file + fsync + ``os.replace``) is the one sanctioned primitive;
    its own ``os.fdopen`` carries the documented suppression."""
    name = "atomic-write"
    description = ("serving/ file writes must use export.atomic_write_text "
                   "(no bare open(..., 'w'))")

    WRITE_MODES = set("wax+")

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        if not module.in_serving:
            return []
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func, module) or ""
            if dn in ("open", "io.open", "os.fdopen"):
                mode = node.args[1] if len(node.args) > 1 else None
                for kw in node.keywords:
                    if kw.arg == "mode":
                        mode = kw.value
                if isinstance(mode, ast.Constant) \
                        and isinstance(mode.value, str) \
                        and set(mode.value) & self.WRITE_MODES:
                    findings.append(self.finding(
                        module, node,
                        f"{dn}(..., {mode.value!r}) in serving/ — a crash "
                        f"mid-write leaves a truncated file; use "
                        f"serving/export.atomic_write_text"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("write_text", "write_bytes"):
                findings.append(self.finding(
                    module, node,
                    f".{node.func.attr}() in serving/ is not atomic; use "
                    f"serving/export.atomic_write_text"))
        return findings


# ---------------------------------------------------------------------------
# clock-injection
# ---------------------------------------------------------------------------

class ClockInjection(Rule):
    """No ambient clocks in serving/ — the injectable engine clock only.

    Mixing clocks fabricates latencies: synthetic submit timestamps beside
    real ``perf_counter`` first-token stamps give negative TTFTs.  Every serving timestamp flows from the ONE
    ``clock`` callable the engine was constructed with (tests inject a
    synthetic clock and get coherent latencies end to end).  The two
    sanctioned exceptions — the engine's default clock parameter and the
    metrics' standalone fallback — carry inline suppressions."""
    name = "clock-injection"
    description = ("no time.time/perf_counter/monotonic in serving/ — use "
                   "the injectable engine clock")

    BANNED = {"time.time", "time.perf_counter", "time.monotonic",
              "time.process_time", "time.clock", "time.time_ns",
              "time.perf_counter_ns", "time.monotonic_ns"}
    BANNED_SUFFIX = ("datetime.now", "datetime.utcnow", "datetime.today")

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        if not module.in_serving:
            return []
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Attribute):
                continue
            dn = dotted_name(node, module) or ""
            if dn in self.BANNED or dn.endswith(self.BANNED_SUFFIX):
                findings.append(self.finding(
                    module, node,
                    f"`{dn}` in serving/ — all timestamps must come from "
                    f"the injectable engine clock (mixed clocks fabricate "
                    f"TTFT/TPOT; see docs/INVARIANTS.md)"))
        return findings


class NoBareAssert(Rule):
    """Runtime invariant checks in serving/ must be explicit raises.

    ``assert`` disappears under ``python -O`` — a production deployment
    running optimized bytecode silently loses the check, and the failure
    it guarded (a leaked block, an out-of-sync admission) resurfaces
    later as corruption with no pointer back to the violated invariant.
    Two real instances motivated this: ``BlockAllocator``'s minimum-pool
    assert and the engine's reserve-after-can_fit assert, both now
    ``raise`` with diagnostic messages.  Schedcheck compounds the
    stakes: its safety battery drives the *real* implementation objects,
    so an invariant demoted to ``assert`` would also vanish from the
    model checker's view under -O.

    Scope is runtime serving/ code only — tests and analysis tooling
    keep ``assert`` (pytest rewrites it; checkers run unoptimized)."""
    name = "no-bare-assert"
    description = ("serving/ runtime invariants must `raise`, not "
                   "`assert` (asserts vanish under python -O)")

    def check(self, module: ModuleInfo, ctx: LintContext) -> list[Finding]:
        if not module.in_serving:
            return []
        return [self.finding(
                    module, node,
                    "bare `assert` in serving/ runtime code — raise an "
                    "explicit exception instead (asserts are stripped "
                    "under python -O, silently disabling the invariant)")
                for node in ast.walk(module.tree)
                if isinstance(node, ast.Assert)]


def all_rules() -> list[Rule]:
    return [StepHostSync(), StepTensorBranch(), PrngDiscipline(),
            RefcountPairing(), AtomicWrite(), ClockInjection(),
            NoBareAssert()]

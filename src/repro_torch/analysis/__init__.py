"""Mechanical enforcement of the serving stack's invariants (twin of
``repro/analysis``).

  * ``repro_torch.analysis.lint`` (+ ``rules``) — reprolint, an AST
    static-analysis pass over the port's modules
    (``python -m repro_torch.analysis lint src/repro_torch``): step
    functions free of host syncs, explicit generators, alloc/free
    pairing, atomic writes, clock injection, no bare asserts.
    Stdlib-only.
  * ``repro_torch.analysis.sanitizer`` — a runtime paged-cache sanitizer
    that records allocation sites and cross-validates refcounts against
    live block tables and the prefix index every engine step.
  * ``repro_torch.analysis.schedcheck`` (+ ``statespace``) — exhaustive
    bounded model checking of the serving control plane
    (``python -m repro_torch.analysis schedcheck``): every interleaving of
    submit/admit/prefill/decode/preempt events on the port's scheduler
    and paged-cache objects, with the sanitizer battery asserted at every
    reachable state and minimized counterexample traces on violation.

``python -m repro_torch.analysis`` runs them under one CLI.  The
reference's fourth layer, tracecheck (+ ``ircost``), reads lowered JAX
IR and has no twin yet: the front end refuses it by name.

Everything is exported lazily, so importing the package pulls in no
submodule (and no torch) until a name is used.
"""
import importlib

__all__ = ["Finding", "Linter", "ModuleInfo", "emit_findings",
           "CacheSanitizer", "SanitizerError",
           "CheckConfig", "ControlPlaneModel", "SCHED_CONFIGS",
           "run_config", "replay_trace",
           "explore", "ExplorationResult", "Violation"]

_EXPORTS = {"Finding": "lint", "Linter": "lint", "ModuleInfo": "lint",
            "emit_findings": "lint",
            "CacheSanitizer": "sanitizer", "SanitizerError": "sanitizer",
            "CheckConfig": "schedcheck", "ControlPlaneModel": "schedcheck",
            "run_config": "schedcheck", "replay_trace": "schedcheck",
            "explore": "statespace", "ExplorationResult": "statespace",
            "Violation": "statespace"}
# schedcheck's config dict is exported under a package-level alias (its
# in-module name, CONFIGS, is too generic at this scope)
_ALIASES = {"SCHED_CONFIGS": ("schedcheck", "CONFIGS")}


def __getattr__(name):
    if name in _ALIASES:
        submodule, attr = _ALIASES[name]
    elif name in _EXPORTS:
        submodule, attr = _EXPORTS[name], name
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(
        importlib.import_module(f"repro_torch.analysis.{submodule}"), attr)

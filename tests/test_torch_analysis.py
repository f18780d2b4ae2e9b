"""The port's reprolint (``repro_torch.analysis.lint`` / ``rules``): the
reference's rule corpus (``tests/test_analysis.py``) re-pointed at the
port, one bad and one good snippet a rule, the two jit rules' cases held
against their torch analogues (``step-host-sync``, ``step-tensor-branch``)
and the one case that has none (``static_argnames``) replaced by the
host-side branches the analogue allows; then the port's tree lints clean,
the CLI's exit codes and its rule list.
"""
from __future__ import annotations

import pathlib

from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.lint import Linter, ModuleInfo, main as lint_main

REPO = pathlib.Path(__file__).resolve().parents[1]


def findings_for(path, src, rule=None):
    select = {rule} if rule else None
    return Linter(select=select).lint_sources({path: src})


def rules_hit(path, src, rule=None):
    return {f.rule for f in findings_for(path, src, rule)}


# ---------------------------------------------------------------------------
# rule corpus: one bad + one good snippet per rule
# ---------------------------------------------------------------------------

def test_step_host_sync_bad_factory():
    src = """
def make_paged_decode_step(arch):
    def step(params, pools, tok):
        v = tok.sum()
        print(v)
        return v.item()
    return step
"""
    fs = findings_for("src/repro_torch/runtime/bad.py", src, "step-host-sync")
    assert len(fs) == 2
    assert any("print()" in f.message for f in fs)
    assert any(".item()" in f.message for f in fs)


def test_step_host_sync_transitive_callee():
    """.cpu() in a helper the step calls — the closure matters, not just
    the factory body."""
    src = """
def helper(x):
    return x.cpu()

def make_decode_step(arch):
    def step(params, tok):
        return helper(tok)
    return step
"""
    fs = findings_for("src/repro_torch/runtime/bad.py", src, "step-host-sync")
    assert len(fs) == 1
    assert ".cpu()" in fs[0].message
    assert "reached from a step function" in fs[0].message


def test_step_host_sync_good():
    src = """
import torch

def make_decode_step(arch):
    def step(params, tok):
        return torch.sum(tok)
    return step
"""
    assert not findings_for("src/repro_torch/runtime/ok.py", src,
                            "step-host-sync")


def test_step_tensor_branch_bad_vs_shape_branch():
    """Branching on a tensor value fires; branching on .shape (host
    metadata) must not."""
    src = """
def make_step(arch):
    def step(params, x):
        B, S = x.shape
        if S > 4:                 # host: fine
            x = x * 2
        if x.sum() > 0:           # tensor: a hidden bool(tensor) sync
            return x
        return -x
    return step
"""
    fs = findings_for("src/repro_torch/runtime/bad.py", src,
                      "step-tensor-branch")
    assert len(fs) == 1
    assert fs[0].line == 7


def test_step_tensor_branch_none_and_numpy_tests_are_host_side():
    """What replaces the reference's static_argnames case (eager PyTorch
    has no jit decorator to read): ``is None``, ``isinstance`` and a test
    on numpy host rows (the sampler's temperature row) read no tensor, so
    they never fire."""
    src = """
import numpy as np

def make_step(arch):
    def step(params, x, cache, temperature):
        if cache is None:
            return x
        if isinstance(x, tuple):
            x = x[0]
        hot = np.asarray(temperature) > 0
        if hot.any():
            return x * 2
        return x
    return step
"""
    assert not findings_for("src/repro_torch/runtime/ok.py", src)


def test_step_tensor_branch_closure_params_are_static():
    """A make_* factory's own parameters are fixed when the step is built
    — the inner function may branch on them freely (make_train_step's
    microbatches switch)."""
    src = """
def make_train_step(arch, microbatches):
    def train_step(params, batch):
        if microbatches == 1:
            return batch
        return batch * 2
    return train_step
"""
    assert not findings_for("src/repro_torch/runtime/ok.py", src,
                            "step-tensor-branch")


def test_prng_discipline_bad():
    src = """
import torch

def bad(seed, vocab):
    torch.manual_seed(seed)
    return torch.randn(vocab)
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src,
                      "prng-discipline")
    assert len(fs) == 2                 # the global seed AND the global draw
    assert any("manual_seed" in f.message for f in fs)
    assert any("randn" in f.message for f in fs)


def test_prng_discipline_good_explicit_generator():
    src = """
import numpy as np
import torch

def draw(seed, vocab, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(vocab, generator=g, device=dev)
    rows = np.random.default_rng(seed).standard_normal(vocab)
    return x, rows
"""
    assert not findings_for("src/repro_torch/serving/ok.py", src,
                            "prng-discipline")


def test_prng_discipline_scoped_to_serving():
    """A global seed outside serving/ (e.g. a training script's init) is
    legitimate."""
    src = """
import torch

def init(seed):
    torch.manual_seed(seed)
    return torch.rand(4)
"""
    assert not findings_for("src/repro_torch/core/ok.py", src,
                            "prng-discipline")


def test_refcount_pairing_leak_on_early_return():
    src = """
def leak(alloc, table, n):
    blocks = alloc.alloc(n)
    if blocks is None:
        return False
    if n > 4:
        return True
    table.extend(blocks)
    return True
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src, "refcount-pairing")
    assert len(fs) == 1
    assert "allocated line 3" in fs[0].message
    assert fs[0].line == 7                    # the leaking return


def test_refcount_pairing_exception_edge():
    """The exception-edge case: a call that can raise between alloc and
    ownership transfer, with no try protecting the blocks."""
    src = """
def edge(alloc, risky, n):
    blocks = alloc.alloc(n)
    if blocks is None:
        return None
    risky(n)
    return blocks
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src, "refcount-pairing")
    assert len(fs) == 1
    assert "exception edge" in fs[0].message


def test_refcount_pairing_discarded_result():
    src = """
def drop(alloc):
    alloc.alloc(1)
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src, "refcount-pairing")
    assert len(fs) == 1
    assert "discarded" in fs[0].message


def test_refcount_pairing_good_patterns():
    """The three sanctioned shapes: try/finally, immediate store (the
    real reserve()), and a decref loop."""
    src = """
def ok_finally(alloc, risky, n):
    blocks = alloc.alloc(n)
    if blocks is None:
        return None
    try:
        risky(n)
    finally:
        alloc.free(blocks)
    return True

def ok_store(self, rid, n):
    got = self.allocator.alloc(n)
    if got is None:
        return False
    self.tables.setdefault(rid, []).extend(got)
    return True

def ok_loop(alloc, n):
    blocks = alloc.alloc(n)
    if blocks is None:
        return
    for b in blocks:
        alloc.decref(b)
"""
    assert not findings_for("src/repro_torch/serving/ok.py", src,
                            "refcount-pairing")


def test_atomic_write_bad():
    src = """
import json
import pathlib

def dump(path, data):
    with open(path, "w") as f:
        json.dump(data, f)
    pathlib.Path(path).write_text("x")
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src, "atomic-write")
    assert len(fs) == 2
    assert all("atomic_write_text" in f.message for f in fs)


def test_atomic_write_reads_are_fine():
    src = """
def load(path):
    with open(path) as f:
        return f.read()
"""
    assert not findings_for("src/repro_torch/serving/ok.py", src, "atomic-write")


def test_clock_injection_bad():
    src = """
import time

def stamp():
    return time.time()
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src, "clock-injection")
    assert len(fs) == 1
    assert "time.time" in fs[0].message


def test_clock_injection_scoped_to_serving():
    src = """
import time

def stamp():
    return time.perf_counter()
"""
    assert not findings_for("src/repro_torch/benchmarks_like/ok.py", src,
                            "clock-injection")


def test_inline_pragma_suppresses_exactly_that_rule():
    src = """
import time

def stamp():
    return time.perf_counter()  # reprolint: disable=clock-injection
"""
    assert not findings_for("src/repro_torch/serving/ok.py", src)
    # a pragma for a different rule must NOT suppress
    src2 = src.replace("clock-injection", "atomic-write")
    assert rules_hit("src/repro_torch/serving/bad.py", src2) == {"clock-injection"}


def test_module_info_serving_scope_detection():
    assert ModuleInfo("src/repro_torch/serving/x.py", "").in_serving
    assert not ModuleInfo("src/repro_torch/runtime/x.py", "").in_serving


def test_serving_scope_covers_cluster_subpackage():
    """The cluster subsystem sits under serving/, so every serving-scoped
    rule applies to it automatically — no per-rule path lists to keep in
    sync as the package grows."""
    assert ModuleInfo("src/repro_torch/serving/cluster/router.py", "").in_serving
    assert ModuleInfo("src/repro_torch/serving/cluster/worker.py", "").in_serving


def test_cluster_paths_hit_serving_scoped_rules():
    clocky = "import time\n\ndef f():\n    return time.monotonic()\n"
    assert rules_hit("src/repro_torch/serving/cluster/router.py", clocky,
                     "clock-injection") == {"clock-injection"}
    asserty = "def f(x):\n    assert x, 'no'\n    return x\n"
    assert rules_hit("src/repro_torch/serving/cluster/frontend.py", asserty,
                     "no-bare-assert") == {"no-bare-assert"}
    writey = ("def dump(path, text):\n"
              "    with open(path, 'w') as f:\n"
              "        f.write(text)\n")
    assert rules_hit("src/repro_torch/serving/cluster/worker.py", writey,
                     "atomic-write") == {"atomic-write"}


def test_cluster_clock_pragma_suppresses_default_arg_line():
    """The Router takes ``clock=time.monotonic`` as an injectable default —
    the sanctioned pattern — and suppresses the banned-name finding with
    the per-line pragma, exactly as serving/metrics.py does."""
    src = ("import time\n\n\n"
           "class Router:\n"
           "    def __init__(self, handles, *,\n"
           "                 clock=time.monotonic):"
           "  # reprolint: disable=clock-injection\n"
           "        self._clock = clock\n")
    assert not findings_for("src/repro_torch/serving/cluster/router.py", src,
                            "clock-injection")


def test_no_bare_assert_bad():
    src = """
def reserve(self, n):
    assert n >= 0, "negative reservation"
    return n
"""
    fs = findings_for("src/repro_torch/serving/bad.py", src, "no-bare-assert")
    assert len(fs) == 1
    assert "python -O" in fs[0].message


def test_no_bare_assert_scoped_to_serving():
    src = "def f(x):\n    assert x\n    return x\n"
    assert not findings_for("src/repro_torch/analysis/ok.py", src,
                            "no-bare-assert")
    assert not findings_for("tests/test_ok.py", src, "no-bare-assert")


def test_no_bare_assert_explicit_raise_is_clean():
    src = """
def reserve(self, n):
    if n < 0:
        raise ValueError("negative reservation")
    return n
"""
    assert not findings_for("src/repro_torch/serving/ok.py", src,
                            "no-bare-assert")


# ---------------------------------------------------------------------------
# the gate itself: merged tree lints clean; CLI exit codes
# ---------------------------------------------------------------------------

def test_merged_tree_is_clean(capsys):
    """The gate in test form: the port's whole package has zero
    unsuppressed findings, through the front end as
    ``python -m repro_torch.analysis lint src/repro_torch`` runs it."""
    findings = Linter().lint_paths([str(REPO / "src" / "repro_torch")])
    assert findings == [], "\n".join(f.format() for f in findings)
    assert analysis_main(["lint", str(REPO / "src" / "repro_torch")]) == 0
    assert "lint: clean" in capsys.readouterr().err


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "serving" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    assert lint_main([str(bad)]) == 1
    assert "clock-injection" in capsys.readouterr().out
    good = tmp_path / "serving" / "ok.py"
    good.write_text("def f():\n    return 1\n")
    assert lint_main([str(good)]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_lists_all_seven_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("step-host-sync", "step-tensor-branch", "prng-discipline",
                 "refcount-pairing", "atomic-write", "clock-injection",
                 "no-bare-assert"):
        assert rule in out
    # each analogue names the reference's jit rule it stands for
    for rule in ("jit-host-sync", "jit-recompile-hazard"):
        assert f"the reference's {rule}" in out

"""tracecheck's twin (``repro_torch.analysis.tracecheck`` + ``ircost``):
the port's serving steps run once under recorders, on the CPU.

Three layers, as the reference's ``tests/test_tracecheck.py``:

  * positive: the five analyzers are clean over qwen3-8b and mamba2-780m
    at smoke size, and a real engine stays within the per-step signature
    budgets over the reference's drained mixed workload for every tiny
    serving family of ``serving_fixtures.ARCH_BY_KEY``;
  * mutation-injection: each analyzer FIRES when its invariant is broken
    (a step that returns a copied cache, an injected ``.item()``, an extra
    output, perturbed and replicated pool specs, zeroed cost tolerances,
    an unpadded prefill chunk);
  * held to the reference: the budgets, the donation table, the cost
    document's fields and the analyzer catalogue; ``ServeGeom`` and
    ``step_kinds``; ``validate_bench``'s errors on the same in-memory
    documents; the cost model's serving predictions, against which the
    port's counted FLOPs stay within ``SERVING_FLOPS_RTOL``.

The reference's own file fails 13 of its tests on jax 0.9.0 (ROADMAP,
"Faults of the reference"), so the twin is held to the reference's
budgets and contracts, not to the counts jax 0.9.0 gives.  The sharding
analyzer runs the (data 4, model 2) mesh over a fake process group of 8
ranks in this process and destroys it before returning.
"""
from __future__ import annotations

import dataclasses
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.core import costmodel as JCM
from repro_torch import configs
from repro_torch import tree
from repro_torch.analysis import ircost as IC
from repro_torch.analysis import tracecheck as TC
from repro_torch.analysis.lint import Finding, emit_findings
from repro_torch.core import costmodel as CM
from repro_torch.core import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.kernels import work as KW
from repro_torch.runtime import steps as ST
from serving_fixtures import ARCH_BY_KEY
from torch_port_fixtures import port_arch


def _reference():
    """The reference's tracecheck and ircost modules, imported when a test
    runs: tracecheck asks for 8 host devices at import (XLA_FLAGS,
    setdefault), which decides the JAX devices of the whole process, so
    it is left to ``tests/test_tracecheck.py``'s own collection."""
    from repro.analysis import ircost as JIC
    from repro.analysis import tracecheck as JTC
    return JTC, JIC

# the reference's test geometry: every step runs in well under a second
GEOM = IC.ServeGeom(slots=2, max_len=32, block_size=8, prefill_chunk=8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The steps here are many small ops: one intra-op thread runs them
    fastest, and leaves the other test workers their cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ctx(arch_or_name) -> TC.ArchContext:
    if isinstance(arch_or_name, str):
        return TC.ArchContext.for_arch(arch_or_name, GEOM, CPU)
    return TC.ArchContext(arch_or_name, GEOM, CPU)


# ---------------------------------------------------------------------------
# positive: clean over reference archs, budgets over every tiny family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-780m"])
def test_analyzers_clean_on_reference_archs(name):
    findings = TC.run_analyzers([name], geom=GEOM, device="cpu")
    assert findings == [], [f.format() for f in findings]
    assert not dist.is_initialized()       # the fake group is gone


@pytest.mark.parametrize("key", sorted(ARCH_BY_KEY))
def test_engine_signature_budget_all_families(key):
    ctx = _ctx(port_arch(ARCH_BY_KEY[key]))
    drained = []
    assert TC.check_trace_cache(ctx, drained=drained.append) == []
    eng, = drained
    assert eng.metrics.preemptions > 0
    assert set(eng.signatures) == set(IC.step_kinds(ctx.arch))
    for kind, seen in eng.signatures.items():
        assert 1 <= len(seen) <= TC.TRACE_BUDGETS[kind], (key, kind, seen)


def test_shapes_only_count_is_the_cpu_count():
    """The count a published-width step gets on the card is held to this
    one: the step under FakeTensorMode on the CPU counts what it counts
    on real CPU tensors."""
    for name in ("qwen3-8b", "mamba2-780m"):
        arch = configs.reduce_for_smoke(configs.get_arch(name))
        for kind in IC.step_kinds(arch):
            real = IC.cost_report(IC.trace_step(arch, kind, GEOM,
                                                device="cpu"))
            fake = IC.cost_report(IC.trace_step(arch, kind, GEOM,
                                                device="cpu",
                                                shapes_only=True))
            assert fake == real, (name, kind)
    IC.clear()


# ---------------------------------------------------------------------------
# mutation-injection: every analyzer fires on its broken invariant
# ---------------------------------------------------------------------------

def _mutated(ctx, kind, wrap):
    """A TracedStep of ``wrap(real step)`` at the engine's arguments."""
    model = IC.build_model(ctx.arch, ctx.geom, device="cpu")
    args = IC.step_arguments(ctx.arch, kind, ctx.geom, model)
    return IC.run_step(ctx.arch, kind, wrap(IC.build_step_fn(ctx.arch, kind)),
                       args, model)


def _inject(ctx, bad):
    ctx.traced = lambda kind, *, meshful=False, mesh=None: bad


def test_donation_analyzer_fires_on_copied_cache():
    ctx = _ctx("qwen3-8b")

    def copying(real):
        def step(params, cache, *rest):
            return real(params, tree.map(torch.clone, cache), *rest)
        return step
    _inject(ctx, _mutated(ctx, "paged_decode", copying))
    findings = TC.check_donation(ctx)
    assert any(f.rule == "donation" and "STEP_DONATION" in f.message
               for f in findings), [f.format() for f in findings]
    assert any("copy of the pool" in f.message for f in findings)


def test_host_transfer_analyzer_fires_on_injected_item():
    ctx = _ctx("qwen3-8b")

    def leaky(real):
        def step(*args):
            out = real(*args)
            out[1].sum().item()                   # a host round trip
            return out
        return step
    _inject(ctx, _mutated(ctx, "paged_decode", leaky))
    findings = TC.check_host_transfer(ctx)
    assert any(f.rule == "host-transfer" and "_local_scalar_dense"
               in f.message for f in findings), [f.format() for f in findings]


def test_host_transfer_analyzer_fires_on_extra_output():
    ctx = _ctx("qwen3-8b")

    def chatty(real):
        def step(*args):
            tok, logp, cache = real(*args)
            return tok, logp, cache, args[0]      # leaks params to host
        return step
    _inject(ctx, _mutated(ctx, "paged_decode", chatty))
    findings = TC.check_host_transfer(ctx)
    assert any("sanctioned" in f.message for f in findings), \
        [f.format() for f in findings]


class _Plan:
    def __init__(self, real, specs):
        self._real, self._specs = real, specs

    def __getattr__(self, name):
        return getattr(self._real, name)

    def paged_cache_specs(self):
        return self._specs(self._real.paged_cache_specs())


def test_sharding_analyzer_fires_on_spec_tree_drift():
    ctx = _ctx("qwen3-8b")

    def drop_v(specs):
        mutated = [dict(seg) for seg in specs]
        first = next(iter(mutated[0]))
        mutated[0][first] = {"k": mutated[0][first]["k"]}    # drop "v"
        return mutated
    ctx._plan = _Plan(ctx.plan, drop_v)
    findings = TC.check_sharding(ctx)
    assert any(f.rule == "sharding" and "tree" in f.message
               for f in findings), [f.format() for f in findings]
    assert not dist.is_initialized()


def test_sharding_analyzer_fires_on_replicated_pool():
    """Declare every pool model-replicated: the placed engine shards kv
    heads over `model`, so conformance must fail."""
    ctx = _ctx("qwen3-8b")
    real = ctx.plan
    assert any("model" in (s or ()) for s in
               SH.spec_leaves(real.paged_cache_specs()))
    ctx._plan = _Plan(real, lambda specs: SH.map_specs(lambda s: SH.P(),
                                                       specs))
    findings = TC.check_sharding(ctx)
    assert any(f.rule == "sharding" and "declares" in f.message
               for f in findings), [f.format() for f in findings]
    assert not dist.is_initialized()


def test_cost_drift_analyzer_fires_on_zero_tolerance(monkeypatch):
    ctx = _ctx("qwen3-8b")
    monkeypatch.setattr(CM, "SERVING_FLOPS_RTOL", 0.0)
    monkeypatch.setattr(CM, "SERVING_BYTES_RFACTOR", 1.0)
    findings = TC.check_cost_drift(ctx)
    assert {f.rule for f in findings} == {"cost-drift"}
    assert len(findings) == 4        # FLOPs and bytes of both steps


def test_trace_cache_analyzer_fires_on_unpadded_chunk(monkeypatch):
    from repro_torch.serving.engine import ContinuousBatchingEngine as CBE

    orig = CBE._prefill_chunk

    def leaky(self):
        ran = orig(self)
        if ran and not getattr(self, "_leaked", False):
            # one extra prefill at HALF the chunk width into the null
            # block: a caller that stops padding gives every distinct
            # prompt tail its own signature
            self._leaked = True
            mbps = self.cache.cfg.max_blocks_per_seq
            self._prefill(
                *self._model(),
                self._tensor(np.zeros((1, self.prefill_chunk // 2),
                                      np.int32)),
                self._tensor(np.zeros((1,), np.int64)),
                self._tensor(np.zeros((1, mbps), np.int32)),
                self._tensor(np.ones((1,), np.int64)), self._slot_ids([0]),
                *self._sampling_rows([None]))
        return ran

    monkeypatch.setattr(CBE, "_prefill_chunk", leaky)
    findings = TC.check_trace_cache(_ctx(port_arch(ARCH_BY_KEY["tiny"])))
    assert any(f.rule == "trace-cache" and "trace signatures" in f.message
               for f in findings), [f.format() for f in findings]


# ---------------------------------------------------------------------------
# held to the reference
# ---------------------------------------------------------------------------

def test_tables_and_catalogue_are_the_references():
    JTC, _ = _reference()
    assert TC.TRACE_BUDGETS == JTC.TRACE_BUDGETS
    assert TC.BENCH_ROW_FIELDS == JTC.BENCH_ROW_FIELDS
    assert {k: d for k, (_, d) in TC.ANALYZERS.items()} == \
        {k: d for k, (_, d) in JTC.ANALYZERS.items()}
    assert list(TC.ANALYZERS) == list(JTC.ANALYZERS)
    from repro.runtime import steps as JST
    assert ST.STEP_DONATION == JST.STEP_DONATION
    assert TC.DEFAULT_GEOM == IC.ServeGeom()
    assert dataclasses.asdict(TC.DEFAULT_GEOM) == \
        dataclasses.asdict(JTC.DEFAULT_GEOM)


@pytest.mark.parametrize("geom", [(4, 64, 8, 16), (2, 32, 8, 8),
                                  (2, 48, 4, 8), (3, 50, 16, 32)])
def test_serve_geom_is_the_references(geom):
    _, JIC = _reference()
    ours, theirs = IC.ServeGeom(*geom), JIC.ServeGeom(*geom)
    for prop in ("max_blocks_per_seq", "num_blocks", "table_len"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop


def test_step_kinds_are_the_references_for_every_arch():
    _, JIC = _reference()
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    for name in configs.ARCHS:
        assert IC.step_kinds(configs.get_arch(name)) == \
            JIC.step_kinds(jconfigs.get_arch(name)), name


def _doc(archs) -> dict:
    rows = [{"arch": f"{a}-smoke", "step": s, "batch": 1, "new_tokens": 8,
             "table_len": 32, "flops_extracted": 1.0e6,
             "flops_predicted": 1.1e6, "flops_rel_err": 0.0909,
             "bytes_extracted": 4.0e6, "bytes_predicted": 1.0e6,
             "bytes_ratio": 4.0, "temp_bytes_peak": 1024}
            for a in sorted(archs) for s in ("paged_prefill", "paged_decode")]
    return {"schema_version": 1,
            "geometry": {"slots": 2, "max_len": 32, "block_size": 8,
                         "prefill_chunk": 8},
            "tolerances": {"flops_rtol": 0.5, "bytes_rfactor": 16.0},
            "rows": rows}


def _documents() -> dict:
    valid = _doc(configs.ARCHS)
    docs = {"valid": valid, "missing key": {"rows": []}}
    bad = json.loads(json.dumps(valid))
    bad["rows"][1]["flops_extracted"] = "many"
    del bad["tolerances"]["bytes_rfactor"]
    docs["non-numeric"] = bad
    over = json.loads(json.dumps(valid))
    over["rows"][0]["flops_rel_err"] = 9.9
    over["rows"][3]["bytes_ratio"] = 99.0
    docs["over tolerance"] = over
    short = json.loads(json.dumps(valid))
    short["rows"].pop()
    del short["rows"][0]["step"]
    docs["missing row"] = short
    return docs


@pytest.mark.parametrize("case", sorted(_documents()))
def test_validate_bench_gives_the_references_errors(case):
    JTC, _ = _reference()
    doc = _documents()[case]
    got = TC.validate_bench(doc)
    assert got == JTC.validate_bench(doc)
    assert (got == []) == (case == "valid")


@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-780m"])
def test_counted_flops_agree_with_the_references_prediction(name):
    arch = configs.reduce_for_smoke(configs.get_arch(name))
    jarch = jconfigs.reduce_for_smoke(jconfigs.get_arch(name))
    ctx = _ctx(name)
    for kind in ("paged_prefill", "paged_decode"):
        row = TC.bench_row(ctx, kind)
        want = JCM.predict_serving_step(jarch, batch=row["batch"],
                                        new_tokens=row["new_tokens"],
                                        table_len=row["table_len"])
        ours = CM.predict_serving_step(arch, batch=row["batch"],
                                       new_tokens=row["new_tokens"],
                                       table_len=row["table_len"])
        assert ours == want
        assert row["flops_predicted"] == want["flops"]
        assert row["flops_rel_err"] <= CM.SERVING_FLOPS_RTOL == \
            JCM.SERVING_FLOPS_RTOL
        assert row["bytes_ratio"] <= CM.SERVING_BYTES_RFACTOR == \
            JCM.SERVING_BYTES_RFACTOR


# ---------------------------------------------------------------------------
# the kernel accounting hook
# ---------------------------------------------------------------------------

def _plain(fn, *args, **kwargs):
    """What one call dispatches with no accounting hook: its aten ops and
    FlopCounterMode's FLOPs (a kernel's plain version, op by op)."""
    ops = set()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.add(func.name())
            return func(*args, **(kwargs or {}))
    with FlopCounterMode(display=False) as fc, Ops():
        fn(*args, **kwargs)
    return ops, fc.get_total_flops()


def test_kernel_hook_counts_rmsnorm_by_its_formula():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 64, generator=g)
    scale = torch.randn(64, generator=g)
    nbytes, flops = KW.rmsnorm_work(6, 64, 4, 4)
    got = IC.count(kops.rmsnorm, x, scale)
    assert (got["bytes"], got["flops"]) == (nbytes, sum(flops.values()))
    assert got["ops"] == {"kernel::rmsnorm"}
    assert got["kernel_calls"] == {"rmsnorm": 1}
    ops, _ = _plain(kops.rmsnorm, x, scale)
    assert len(ops) > 2            # the plain version's ops, not counted


def test_kernel_hook_counts_the_ssd_scan_by_its_formula():
    g = torch.Generator().manual_seed(0)
    B, S, H, P, G, N, Q = 1, 12, 4, 8, 2, 16, 8
    x = torch.randn(B, S, H, P, generator=g)
    Bm = torch.randn(B, S, G, N, generator=g)
    Cm = torch.randn(B, S, G, N, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.1
    h0 = torch.randn(B, H, P, N, generator=g)
    nbytes, _ = KW.ssd_work(B, S, H, P, N, G, Q, "float32", 4, True)
    got = IC.count(kops.ssd_scan, x, Bm, Cm, dt, -dt, h0, chunk=Q)
    assert got["bytes"] == nbytes
    assert got["flops"] == sum(KW.ssd_products(B, S, H, P, N, G, Q))
    assert got["ops"] == {"kernel::ssd_scan"}
    ops, flops = _plain(kops.ssd_scan, x, Bm, Cm, dt, -dt, h0, chunk=Q)
    assert len(ops) > 2 and 0 < flops != got["flops"]


def test_kernel_calls_in_a_step_are_each_forwards():
    """Each traced step calls every kernel as often as one forward does
    (chip_smoke.py's ``forward_launches``: two norms a block, q/k norms,
    the final norm; mamba2's scan only in the prefill chunk)."""
    for name in ("qwen3-8b", "mamba2-780m"):
        arch = configs.reduce_for_smoke(configs.get_arch(name))
        layers = sum(s.repeat * len(s.blocks) for s in arch.pattern)
        norms = (4 if arch.qk_norm else 2) * layers + 1
        for kind in ("paged_prefill", "paged_decode"):
            calls = IC.cost_report(IC.trace_step(
                arch, kind, GEOM, device="cpu"))["kernel_calls"]
            want = {"rmsnorm": norms}
            if name == "mamba2-780m" and kind == "paged_prefill":
                want["ssd_scan"] = layers
            assert calls == want, (name, kind, calls)
    IC.clear()


# ---------------------------------------------------------------------------
# CLI and the finding emitters
# ---------------------------------------------------------------------------

def test_cli_round_trip_and_device_flag(tmp_path, capsys, monkeypatch):
    assert TC.main(["--list-analyzers"]) == 0
    out = capsys.readouterr().out
    for name in TC.ANALYZERS:
        assert name in out
    with pytest.raises(SystemExit):
        TC.main(["--select", "nope", "--device", "cpu"])
    bench = tmp_path / "costs.json"
    assert TC.main(["--device", "cpu", "--arch", "qwen3-8b",
                    "--write-bench", str(bench)]) == 0
    doc = json.loads(bench.read_text())
    assert [r["step"] for r in doc["rows"]] == ["paged_prefill",
                                                "paged_decode"]
    assert TC.validate_bench(doc, require_archs=["qwen3-8b"]) == []
    capsys.readouterr()
    # the whole registry is required: every other arch's rows are missing
    assert TC.main(["--validate-bench", str(bench)]) == 1
    out = capsys.readouterr().out
    assert "no row for mamba2-780m-smoke/paged_decode" in out
    assert "INVALID" in out
    bench.write_text(json.dumps(_doc(configs.ARCHS)))
    assert TC.main(["--validate-bench", str(bench)]) == 0
    assert "bench valid" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        TC.main(["--arch", "qwen3-8b"])
    assert TC.main(["--device", "cpu", "--arch", "mamba2-780m", "--select",
                    "host-transfer,donation", "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


_FINDINGS = [Finding("qwen3-8b-smoke/paged_prefill", 0, 0, "cost-drift",
                     "bad\ncount"),
             Finding("qwen3-8b-smoke/paged_decode", 0, 0, "donation",
                     "cache copied")]


def test_emit_findings_json_round_trips():
    buf = io.StringIO()
    emit_findings(_FINDINGS, "json", tool="tracecheck", stream=buf)
    parsed = json.loads(buf.getvalue())
    assert [p["rule"] for p in parsed] == ["cost-drift", "donation"]
    assert parsed[1]["path"].endswith("decode")


def test_emit_findings_github_annotations():
    buf = io.StringIO()
    emit_findings(_FINDINGS, "github", tool="tracecheck", stream=buf)
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("::error file=qwen3-8b-smoke/paged_prefill,"
                               "line=0,col=0,title=tracecheck(cost-drift)::")
    assert "%0A" in lines[0] and "\n" not in lines[0][2:]
    assert "title=tracecheck(donation)" in lines[1]

"""The port's observability and control plane on the CPU: the Chrome tracer,
the exporters, ``StepMonitor``, the cache sanitizer, the host-only cache
and its state dicts, and the serve launcher's flags.

The reference's own tests (tests/test_telemetry.py's tracer, exporter and
monitor tests; tests/test_analysis.py's sanitizer tests;
tests/test_data_checkpoint.py's host-state round trips) are re-pointed at
the port with the port fixture's params, which are built under the
goldens' RNG: the reference's ``test_tracer_disabled_is_free_on_the_engine``
fails on this jax only because its params are built under the new default
RNG and miss the goldens.  The host-state round trip goes through JSON
rather than ``checkpoint/store.py`` (not ported), on a mid-flight engine
rather than a schedcheck model (not ported).

Under one synthetic clock the port's trace events (name, phase, id, args
and ts: both engines read the clock at the same points) and its
Prometheus text equal the JAX engine's.
"""
import json

import numpy as np
import pytest

from repro_torch.analysis.sanitizer import CacheSanitizer, SanitizerError
from repro_torch.core.profiler import StepMonitor
from repro_torch.serving import (ChromeTracer, ContinuousBatchingEngine,
                                 PagedKVCache, Request, RequestScheduler,
                                 SamplingParams, ServingMetrics,
                                 SnapshotWriter, atomic_write_text,
                                 prometheus_text, validate_chrome_trace)
from repro_torch.serving.export import parse_prometheus_text
from repro_torch.serving.paged_cache import NULL_BLOCK, PagedCacheConfig
from serving_fixtures import TINY, load_goldens, scenario_requests
from torch_port_fixtures import jax_params, port_arch, torch_params


def _synthetic_clock():
    state = {"t": 0.0}

    def clk():
        state["t"] += 1e-3
        return state["t"]
    return clk


def _engine(arch=TINY, **kw):
    return ContinuousBatchingEngine(port_arch(arch), torch_params(arch),
                                    device="cpu", **kw)


def _scenario(name, engine, sampling=None):
    _, reqs, _, _ = scenario_requests(name)
    return engine.generate([Request(id=rid, prompt=p.copy(),
                                    max_new_tokens=mn,
                                    sampling=sampling or SamplingParams())
                            for rid, p, mn in reqs])


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_trace_schema_valid_on_forced_preemption_run(tmp_path):
    arch, reqs, slots, max_len = scenario_requests("tiny/preempt")
    tracer = ChromeTracer()
    eng = _engine(arch, slots=slots, max_len=max_len, block_size=4,
                  num_blocks=8, prefill_chunk=8, clock=_synthetic_clock(),
                  tracer=tracer)
    outs = _scenario("tiny/preempt", eng)
    assert eng.metrics.preemptions > 0
    assert {o.request_id: o.token_ids for o in outs} == \
        load_goldens("tiny/preempt")          # tracing changes no tokens
    trace = tracer.write(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == trace
    stats = validate_chrome_trace(trace)
    assert stats["n_request_spans"] == len(reqs)
    assert stats["n_phase_spans"] > 0
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"admission", "prefill", "decode", "sample_sync",
            "preempt", "resume", "first_token", "admitted"} <= names
    meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "thread_name" for e in meta)
    assert any(e["ph"] == "C" and e["name"] == "queue_depth"
               for e in trace["traceEvents"])
    assert eng.metrics.phase["decode"].count > 0
    assert eng.metrics.phase["sample_sync"].count > 0


def test_trace_validator_rejects_malformed_traces():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({})
    base = {"pid": 0, "tid": 1, "ts": 0.0}
    with pytest.raises(ValueError, match="missing"):
        validate_chrome_trace({"traceEvents": [{"ph": "B", "ts": 0.0}]})
    with pytest.raises(ValueError, match="unbalanced"):
        validate_chrome_trace(
            {"traceEvents": [dict(base, name="p", ph="B")]})
    with pytest.raises(ValueError, match="time-sorted"):
        validate_chrome_trace({"traceEvents": [
            dict(base, name="p", ph="B", ts=5.0),
            dict(base, name="p", ph="E", ts=1.0)]})
    with pytest.raises(ValueError, match="no open B"):
        validate_chrome_trace({"traceEvents": [
            dict(base, name="p", ph="E")]})
    with pytest.raises(ValueError, match="closes"):
        validate_chrome_trace({"traceEvents": [
            dict(base, name="p", ph="B"),
            dict(base, name="q", ph="E", ts=1.0)]})
    with pytest.raises(ValueError, match="no open begin"):
        validate_chrome_trace({"traceEvents": [
            dict(base, name="r", ph="e", cat="request", id=1)]})


def test_tracer_disabled_is_free_on_the_engine():
    """The reference's version fails on this jax (its params miss the
    goldens); here the engine without a tracer still gives them."""
    arch, reqs, slots, max_len = scenario_requests("tiny/base")
    eng = _engine(arch, slots=slots, max_len=max_len,
                  clock=_synthetic_clock())
    assert eng.tracer is None
    outs = _scenario("tiny/base", eng)
    assert {o.request_id: o.token_ids for o in outs} == \
        load_goldens("tiny/base")


def test_trace_and_prometheus_equal_the_jax_engines():
    """tiny/preempt with sampled requests and forced preemption, both
    engines on the same synthetic clock: every trace event (name, ph, id,
    cat, args, ts) is equal in order, and so is every line of
    ``prometheus_text``."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ChromeTracer as JaxTracer
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSamplingParams
    from repro.serving import prometheus_text as jax_prometheus_text

    arch, reqs, slots, max_len = scenario_requests("tiny/preempt")
    kw = dict(slots=slots, max_len=max_len, block_size=4, num_blocks=8,
              prefill_chunk=8)
    jtr, ttr = JaxTracer(), ChromeTracer()
    jeng = JaxEngine(arch, jax_params(arch), make_host_mesh(),
                     clock=_synthetic_clock(), tracer=jtr, **kw)
    teng = _engine(arch, clock=_synthetic_clock(), tracer=ttr, **kw)
    for eng, make_req, make_sp in ((jeng, JaxRequest, JaxSamplingParams),
                                   (teng, Request, SamplingParams)):
        eng.generate([make_req(id=rid, prompt=p.copy(), max_new_tokens=mn,
                               sampling=make_sp(temperature=0.7 * (rid % 2),
                                                seed=rid))
                      for rid, p, mn in reqs])
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
    assert ttr.to_dict() == jtr.to_dict()
    assert prometheus_text(teng.metrics).splitlines() == \
        jax_prometheus_text(jeng.metrics).splitlines()


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def test_atomic_write_overwrites_and_leaves_no_temp(tmp_path):
    p = tmp_path / "out.json"
    atomic_write_text(p, "first\n")
    atomic_write_text(p, "second\n")
    assert p.read_text() == "second\n"
    assert [f.name for f in tmp_path.iterdir()] == ["out.json"]


def test_metrics_write_is_atomic(tmp_path):
    m = ServingMetrics()
    m.on_submit(0, now=0.0)
    m.on_first_token(0, now=0.1)
    m.on_finish(0, n_tokens=2, now=0.5)
    path = tmp_path / "metrics.json"
    m.write(str(path), engine="test")
    rep = json.loads(path.read_text())
    assert rep["engine"] == "test" and rep["completed"] == 1
    assert [f.name for f in tmp_path.iterdir()] == ["metrics.json"]


def test_prometheus_text_round_trip():
    m = ServingMetrics()
    m.on_submit(0, now=0.0, prompt_len=8)
    m.on_first_token(0, now=0.2)
    m.on_step(queue_depth=3, busy_slots=1, slots=2, block_utilization=0.5,
              now=0.3)
    m.on_phase("decode", 0.01)
    m.on_step_time(0.02, ema=0.02, drift=0.0)
    m.on_finish(0, n_tokens=4, now=0.5, reason="length")
    parsed = parse_prometheus_text(prometheus_text(m))
    assert parsed["repro_serving_requests_completed_total"][0][1] == "1.0"
    assert parsed["repro_serving_tokens_generated_total"][0][1] == "4.0"
    buckets = parsed["repro_serving_queue_depth_bucket"]
    assert buckets[-1][0]["le"] == "+Inf" and buckets[-1][1] == "1"
    assert parsed["repro_serving_queue_depth_count"][0][1] == "1"
    cums = [int(v) for lab, v in buckets]
    assert cums == sorted(cums)
    parsed_empty = parse_prometheus_text(prometheus_text(ServingMetrics()))
    assert parsed_empty["repro_serving_step_time_ema_s"][0][1] == "NaN"


def test_prometheus_labels():
    m = ServingMetrics()
    m.on_step(1, 1, 2, now=0.0)
    parsed = parse_prometheus_text(
        prometheus_text(m, labels={"arch": "tiny-serve"}))
    labels, _ = parsed["repro_serving_engine_steps_total"][0]
    assert labels == {"arch": "tiny-serve"}


def test_snapshot_writer_cadence_and_atomicity(tmp_path):
    m = ServingMetrics()
    path = tmp_path / "snap.jsonl"
    w = SnapshotWriter(path, every_s=1.0)
    assert w.maybe_write(m, 0.0)
    assert not w.maybe_write(m, 0.5)
    assert not w.maybe_write(m, 0.99)
    assert w.maybe_write(m, 1.0)
    assert w.maybe_write(m, 5.0)
    assert w.n_snapshots == 3
    lines = path.read_text().splitlines()
    assert len(lines) == 3
    for line in lines:
        snap = json.loads(line)
        assert "window" in snap and "engine_steps" in snap
    with pytest.raises(ValueError):
        SnapshotWriter(path, every_s=0.0)


# ---------------------------------------------------------------------------
# StepMonitor through the facade
# ---------------------------------------------------------------------------

def test_step_monitor_drift_exported_as_telemetry():
    mon = StepMonitor(alpha=1.0, drift_threshold=0.25, min_steps=2)
    m = ServingMetrics()
    for _ in range(2):
        trig = mon.update(0.010)
        m.on_step_time(0.010, ema=mon.ema, drift=mon.drift_fraction(),
                       triggered=trig)
    sig = m.window_signals(now=0.0)
    assert sig["step_time_ema_s"] == pytest.approx(0.010)
    assert sig["step_time_drift"] == pytest.approx(0.0)
    assert sig["replan_triggers"] == 0
    trig = mon.update(0.020)
    assert trig
    m.on_step_time(0.020, ema=mon.ema, drift=mon.drift_fraction(),
                   triggered=trig)
    assert m.window_signals(now=0.0)["replan_triggers"] == 1
    assert m.step_time.count == 3


def test_engine_runs_step_monitor_and_phase_histograms():
    arch, reqs, slots, max_len = scenario_requests("tiny/base")
    eng = _engine(arch, slots=slots, max_len=max_len,
                  clock=_synthetic_clock())
    _scenario("tiny/base", eng)
    s = eng.metrics.summary()
    assert eng.step_monitor.steps == s["engine_steps"] > 0
    assert s["step_time"]["count"] == s["engine_steps"]
    assert s["window"]["step_time_ema_s"] is not None
    assert s["phases"]["prefill"]["count"] == s["prefill_chunks"]
    assert s["phases"]["decode"]["count"] == s["decode_steps"]
    assert s["phases"]["sample_sync"]["count"] == s["decode_steps"]
    assert s["scheduler"]["admitted"] >= len(reqs)
    assert s["cache"]["num_blocks"] == eng.cache.cfg.num_blocks
    assert s["cache"]["pool_bytes"] > 0


# ---------------------------------------------------------------------------
# the cache sanitizer (tests/test_analysis.py's cases)
# ---------------------------------------------------------------------------

def _san_engine(**kw):
    kw.setdefault("sanitizer", CacheSanitizer())
    return _engine(slots=kw.pop("slots", 2), max_len=kw.pop("max_len", 64),
                   block_size=kw.pop("block_size", 4),
                   prefill_chunk=kw.pop("prefill_chunk", 8), **kw)


def _san_reqs(n, plen=10, max_new=8, shared=0):
    common = np.arange(1, shared + 1, dtype=np.int32)
    return [Request(id=i,
                    prompt=np.concatenate(
                        [common, np.arange(40 + 5 * i, 40 + 5 * i + plen,
                                           dtype=np.int32) % 250 + 1]),
                    max_new_tokens=max_new,
                    sampling=SamplingParams(temperature=0.7, seed=i))
            for i in range(n)]


def _host_cache():
    return PagedKVCache.host_only(PagedCacheConfig(
        block_size=4, num_blocks=10, max_blocks_per_seq=8))


def test_sanitizer_clean_under_preemption_and_sharing():
    eng = _san_engine(slots=3, num_blocks=13, share_prefix=True)
    outs = eng.generate(_san_reqs(8, shared=12, max_new=10))
    assert len(outs) == 8
    assert eng.metrics.preemptions > 0
    rep = eng.sanitizer.report()
    assert rep["violations"] == 0
    assert rep["step_checks"] > 0 and rep["allocs"] > 0


def test_sanitizer_env_var_auto_attach(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    eng = _san_engine(sanitizer=None)
    assert isinstance(eng.sanitizer, CacheSanitizer)
    assert eng.cache.allocator.observer is eng.sanitizer
    monkeypatch.delenv("REPRO_SANITIZE")
    eng = _san_engine(sanitizer=None)
    assert eng.sanitizer is None and eng.cache.allocator.observer is None


def test_sanitizer_detects_double_free_with_sites():
    cache = _host_cache()
    san = CacheSanitizer().attach(cache)
    assert cache.reserve(0, 8)
    victim = cache.tables[0][0]
    cache.release(0)
    with pytest.raises(SanitizerError) as e:
        cache.allocator.decref(victim)
    msg = str(e.value)
    assert "double free" in msg
    assert "allocated at" in msg and "previously freed at" in msg
    assert "test_torch_telemetry.py" in msg
    assert san.counters["violations"] == 1


def test_sanitizer_detects_stale_incref():
    cache = _host_cache()
    CacheSanitizer().attach(cache)
    assert cache.reserve(0, 8)
    stale = cache.tables[0][-1]
    cache.release(0)
    with pytest.raises(SanitizerError, match="stale reference"):
        cache.allocator.incref(stale)
    with pytest.raises(SanitizerError, match="null block"):
        cache.allocator.incref(NULL_BLOCK)


def test_sanitizer_detects_refcount_table_mismatch():
    cache = _host_cache()
    san = CacheSanitizer().attach(cache)
    assert cache.reserve(0, 8)
    cache.allocator.incref(cache.tables[0][0])     # stranded reference
    with pytest.raises(SanitizerError) as e:
        san.check_cache()
    assert "refcount mismatch" in str(e.value)
    assert "allocated at" in str(e.value)


# ---------------------------------------------------------------------------
# host-only cache and state dicts (tests/test_data_checkpoint.py's cases)
# ---------------------------------------------------------------------------

def _midflight():
    """An engine stopped mid-flight with queued, running and finished
    requests under prefix sharing: tables, index, LRU and cursors all
    hold something."""
    eng = _engine(slots=2, max_len=64, block_size=4, prefill_chunk=4,
                  num_blocks=14, share_prefix=True,
                  scheduler=RequestScheduler(max_tokens_in_flight=80))
    for r in _san_reqs(5, plen=4, max_new=3, shared=8):
        eng.submit(r)
    while len(eng.completed) < 2:
        eng.step()
    return eng


def test_host_state_round_trips_through_json():
    eng = _midflight()
    cache, sched = eng.cache, eng.scheduler
    sd, cd = sched.state_dict(), cache.host_state_dict()
    assert sd["queue"] and cd["tables"] and cd["prefix_index"]
    assert cd["lru"] and cd["committed"]
    blob = json.loads(json.dumps({"scheduler": sd, "cache": cd}))
    sched2 = RequestScheduler()
    sched2.load_state_dict(blob["scheduler"], dict(eng._states))
    cache2 = PagedKVCache.host_only(cache.cfg)
    cache2.load_host_state_dict(blob["cache"])
    assert cache2.pools is None and cache2.arch is None
    assert sched2.state_dict() == sd
    assert cache2.host_state_dict() == cd
    probe = eng._states[4].prompt
    assert cache2.match_prefix(tuple(probe)) == \
        cache.match_prefix(tuple(probe)) != []
    # the restored bookkeeping keeps working: the next reserve takes the
    # same physical blocks in both
    assert cache2.reserve(77, 9) == cache.reserve(77, 9)
    assert cache2.tables[77] == cache.tables[77]


def test_host_state_round_trip_survives_empty_control_plane():
    sched = RequestScheduler(max_tokens_in_flight=7, footprint_cap=5)
    cfg = PagedCacheConfig(block_size=2, num_blocks=4, max_blocks_per_seq=4,
                           share_prefix=True)
    cache = PagedKVCache.host_only(cfg)
    blob = json.loads(json.dumps({"scheduler": sched.state_dict(),
                                  "cache": cache.host_state_dict()}))
    sched2 = RequestScheduler()
    sched2.load_state_dict(blob["scheduler"], {})
    cache2 = PagedKVCache.host_only(cfg)
    cache2.load_host_state_dict(blob["cache"])
    assert sched2.state_dict() == sched.state_dict()
    assert sched2.max_tokens_in_flight == 7
    assert cache2.host_state_dict() == cache.host_state_dict()
    assert cache2.allocator.num_free == cache.allocator.num_free


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------

def test_serve_cli_samples_traces_exports_and_sanitizes(tmp_path, capsys):
    from repro_torch.launch import serve
    out = tmp_path / "m.json"
    serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                "--requests", "4", "--prompt-len", "6", "--max-new", "4",
                "--max-len", "32", "--prefill-chunk", "4",
                "--temperature", "0.8", "--top-p", "0.95", "--seed", "7",
                "--stop", "11,12", "--logprobs",
                "--trace-out", str(tmp_path / "t.json"),
                "--prom-out", str(tmp_path / "m.prom"),
                "--metrics-out", str(out), "--metrics-every", "0.001",
                "--sanitize"])
    text = capsys.readouterr().out
    assert "[continuous/T=0.8 top_k=0 top_p=0.95 seed=7] 4 requests" in text
    assert "logprobs[:3]=" in text and "sanitizer: clean" in text
    stats = validate_chrome_trace(json.loads((tmp_path / "t.json")
                                             .read_text()))
    assert stats["n_request_spans"] == 4
    parsed = parse_prometheus_text((tmp_path / "m.prom").read_text())
    assert parsed["repro_serving_requests_completed_total"][0][1] == "4.0"
    lines = (tmp_path / "m.json.jsonl").read_text().splitlines()
    assert len(lines) > 1
    for line in lines:
        assert "window" in json.loads(line)
    assert json.loads(out.read_text())["completed"] == 4


@pytest.mark.parametrize("flags", [
    ["--engine", "wave", "--temperature", "0.5"],
    ["--engine", "wave", "--logprobs"],
    ["--engine", "wave", "--trace-out", "t.json"],
    ["--engine", "wave", "--sanitize"],
    ["--metrics-every", "1.0"],
], ids=["wave-sampling", "wave-logprobs", "wave-trace", "wave-sanitize",
        "every-without-out"])
def test_serve_cli_refuses_what_the_reference_refuses(flags, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu"]
                   + flags)
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_serve_cli_wave_shim_delegates_to_the_engine(capsys):
    from repro_torch.launch import serve
    with pytest.warns(DeprecationWarning, match="compatibility shim"):
        serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                    "--engine", "wave", "--requests", "3", "--prompt-len",
                    "6", "--max-new", "3", "--max-len", "32"])
    assert "[wave-shim] 3 requests, 9 tokens" in capsys.readouterr().out

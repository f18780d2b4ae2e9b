"""The PyTorch port's example twins (``src/repro_torch/examples/``)
against the reference's examples (``examples/*.py``), on the CPU.

Where a reference example builds its own params (``init_lm`` from
PRNGKey(0) under jax's default RNG), the twin runs on those params
converted leaf for leaf, and the printed result lines are compared:
greedy and seeded sampled tokens are equal (the port draws JAX's own
threefry stream), and so are the finish reasons.  The planner demo is
held to the reference scheduler's plans exactly.  The reference's
``Trainer.train`` raises under jax 0.9.0's Explicit mesh, so the live
re-plan demo is held to the same Trainer with ``replan_every=0``
(``test_torch_examples_train.py``, with the hybrid serving example).
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, SHAPES, reduce_for_smoke
from repro.core.asa import AdaptiveScheduler as JScheduler
from repro.core.costmodel import MeshShape as JMesh
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.examples import adaptive_switch as AS
from repro_torch.examples import serve_continuous as SC
from repro_torch.examples import serve_lm as SL

import torch_port_fixtures as FX

REPO = pathlib.Path(__file__).resolve().parents[1]
_REFS: dict = {}


def _reference(name: str):
    """The reference example ``examples/<name>.py`` as a module."""
    if name not in _REFS:
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}", REPO / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _REFS[name] = mod
    return _REFS[name]


def _params(arch):
    """The reference example's params and their conversion."""
    jp = JT.init_lm(jax.random.PRNGKey(0), arch)
    return jp, convert.to_torch(jax.tree.map(np.asarray, jp))


def _printed(fn, *args, **kwargs) -> tuple:
    """(fn's result, its printed lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def _results(lines) -> list:
    """The per-request result lines, without their timings."""
    return [re.sub(r",? ?ttft \d+ms", "", l) for l in lines
            if l.startswith("  req ")]


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' models are tiny: one intra-op thread runs them ~25x
    faster than eight on a loaded host (the other test workers)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def qwen():
    arch = reduce_for_smoke(ARCHS["qwen3-8b"])
    return (arch, FX.port_arch(arch)) + _params(arch)


def test_serve_lm_legacy_tokens_equal_the_reference(qwen):
    arch, parch, jp, tp = qwen
    _, want = _printed(_reference("serve_lm").serve_legacy, arch, jp,
                       make_host_mesh())
    done, got = _printed(SL.serve_legacy, parch, tp, "cpu")
    assert len(done) == 10 and all(len(r.out_tokens) == 12 for r in done)
    assert _results(got) == _results(want) and len(_results(got)) == 3


def test_serve_lm_share_prefix_hits_and_equals_the_reference(qwen):
    arch, parch, jp, tp = qwen
    _, want = _printed(_reference("serve_lm").serve_shared_prefix, arch, jp,
                       make_host_mesh())
    (outs, summary, stats), got = _printed(SL.serve_shared_prefix, parch,
                                           tp, "cpu")
    assert summary["prefix_hit_rate"] > 0 and stats["hit_tokens"] > 0
    assert _results(got) == _results(want)
    cache_line = [l for l in want if l.startswith("cache: ")]
    assert cache_line == [f"cache: {stats}"]


def test_plan_shift_demo_equals_the_reference():
    """Methods, strategy histograms, microbatches and predicted times,
    before and after calibration, equal the reference scheduler's (the
    example's printed lines too)."""
    rows, got = _printed(AS.plan_shift_demo)
    _, want = _printed(_reference("adaptive_switch").plan_shift_demo)
    assert got == want
    sched = JScheduler(faithful=False, opt_preset="adamw8bit")
    arch = ARCHS["qwen3-8b"]
    for row, shape in zip(rows, ("train_4k", "prefill_32k", "decode_32k")):
        plan = sched.plan(arch, SHAPES[shape], JMesh(16, 16))
        hist = {}
        for s in plan.assignment.values():
            hist[str(s)] = hist.get(str(s), 0) + 1
        assert row == {"shape": shape, "method": plan.plan.method,
                       "hist": hist, "microbatches": plan.microbatches,
                       "time": plan.plan.cost["time"]}
    sched.calibrate({c.name: (3.0 if "mixer" in c.name else 1.0)
                     for c in plan.comps}, {c.name: 1.0 for c in plan.comps})
    plan2 = sched.replan(arch, SHAPES["decode_32k"], JMesh(16, 16))
    assert rows[3]["method"] == plan2.plan.method
    assert rows[3]["time"] == plan2.plan.cost["time"]
    assert rows[3]["time"] != rows[2]["time"]


def test_serve_continuous_equals_the_reference(qwen):
    arch, parch, jp, tp = qwen
    ref = _reference("serve_continuous")
    mesh = make_host_mesh()
    eng = ref.ContinuousBatchingEngine(
        arch, jp, mesh, slots=4, max_len=128, block_size=16,
        prefill_chunk=32,
        scheduler=ref.RequestScheduler(max_tokens_in_flight=512))
    want = eng.generate(_reference_requests(ref, arch))
    (outs, summary, streamed), lines = _printed(SC.run, parch, tp, "cpu")
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in want]
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    assert summary["completed"] == 10
    assert len(streamed) == summary["total_tokens"] == 120


def _reference_requests(ref, arch) -> list:
    """The reference example's ten requests (its ``main``'s loop)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(10):
        prompt_len = int(rng.integers(8, 48))
        sampling = (ref.SamplingParams() if i % 2 == 0 else
                    ref.SamplingParams(temperature=0.8, top_p=0.95, seed=i,
                                       logprobs=True))
        out.append(ref.Request(
            id=i, prompt=rng.integers(1, arch.vocab, size=prompt_len)
            .astype(np.int32), max_new_tokens=12,
            priority=0 if i % 3 == 0 else 1, sampling=sampling))
    return out

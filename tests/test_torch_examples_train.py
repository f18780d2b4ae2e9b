"""The PyTorch port's re-planning Trainer demo and hybrid serving
example (``src/repro_torch/examples/adaptive_switch.py::live_replan_demo``,
``serve_hybrid_archs.py``) against the reference's examples, on the CPU
(kept apart from ``test_torch_examples.py`` so that the two files' work
spreads over the test workers).

The reference's ``Trainer.train`` raises under jax 0.9.0's Explicit mesh
(ROADMAP, faults of the reference), so the live re-plan demo is held to
the same Trainer with ``replan_every=0``: a re-plan on a world of 1 keeps
the plan, so the losses are bit-equal — under
``torch.use_deterministic_algorithms``, without which two runs of one
step on this CPU already differ in the last bits.  The hybrid example
runs on the reference example's params converted leaf for leaf, and its
printed result lines equal the reference's.
"""
from __future__ import annotations

import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.launch.mesh import make_host_mesh
from repro_torch.examples import adaptive_switch as AS
from repro_torch.examples import serve_hybrid_archs as SH

from test_torch_examples import (_params, _printed, _reference, _results,
                                 one_thread)  # noqa: F401 (autouse)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_live_replan_demo_replans_and_keeps_the_losses(deterministic):
    hist, replans = AS.live_replan_demo("cpu")
    assert {20, 40, 60} <= set(replans) and len(hist) == 60
    # step-time drift may add re-plans (the times are the host's); none
    # moves a loss, since a world of 1 keeps its plan
    base, _ = AS.live_replan_demo("cpu", replan_every=0)
    assert [m["loss"] for m in hist] == [m["loss"] for m in base]
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("name,frontend", [("zamba2-2.7b", None),
                                           ("whisper-medium", "audio")])
def test_serve_hybrid_archs_equals_the_reference(name, frontend):
    arch = reduce_for_smoke(ARCHS[name])
    _, want = _printed(_reference("serve_hybrid_archs").serve, name,
                       make_host_mesh(), frontend_for=frontend)
    _, tp = _params(arch)
    (outs, summary, has_fe), got = _printed(SH.serve, name, "cpu",
                                            frontend_for=frontend, params=tp)
    assert summary["completed"] == 8
    assert all(o.finish_reason == "length" for o in outs)
    assert _results(got) == _results(want)
    assert has_fe == ({0, 2, 4, 6} if frontend else set())

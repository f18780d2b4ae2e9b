"""The port's engine placed on a ``DeviceMesh`` by the ASA plan
(``serving/placement.py``) on the CPU.

Four gloo ranks, spawned once for this module
(``torch_serve_dist_worker.py``, which imports no JAX; this process hands
them the reference's params under the goldens' RNG as numpy), serve the
reference's placement scenarios (``tests/test_serving.py``'s
multi-device tests, which need 8 JAX devices), and the SSM, shared,
enc-dec and cross goldens, on a (data 2, model 2) mesh: the greedy tokens
equal the goldens, every pool leaf lies as ``plan.paged_cache_specs()``
says, with the leaves the reference's planner shards over `model` really
split (``SPLIT``), each block runs its tensor-parallel function on its own
pool shards (``BLOCK_FNS``: the MLA blocks too, on their heads and
experts, their latent pools replicated and nothing gathered around them),
and the plan's assignment equals the reference planner's for the same
arch, shape and mesh shape.

A case of 6 Q heads over 3 KV heads keeps its KV weights and pools whole
on (2, 2): each rank picks the KV heads of its Q heads, and the tokens
equal the unplaced engine's.  Arctic's shape (tiny-moe: GQA attention by
heads, 8 experts 4 a rank, the dense FFN by d_ff; its prefill chunks drop
tokens) gives the JAX engine's tokens on the same params and settings,
and the unplaced engine's; so does it under the EP-major layout (experts
over `data`, their FF dim over `model`, one all-reduce over the world).
Two cases with a frontend in every request
and llama-vision's gates opened (the goldens were frozen without
frontends, gates shut) give the JAX engine's tokens on the same params
and frontends, and the unplaced engine's: whisper's encoder runs on each rank's heads at
admission, which writes each rank's heads of the cross K/V, and the cross
attention reads them.

In this process, on a world of 1: the placed engine equals the unplaced
one bit for bit (tokens and logprobs), and ``Server.plan`` is the
engine's.
"""
import pathlib
import pickle
import tempfile
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_serve_dist_worker as W
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MoESpec as JMoESpec
from repro.configs.base import Segment as JSegment
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.asa import AdaptiveScheduler as JAdaptiveScheduler
from repro.core.costmodel import MeshShape as JMeshShape
from repro_torch.launch import mesh as M
from repro_torch.serving.engine import ContinuousBatchingEngine, Request
from repro_torch.serving.sampling import SamplingParams
from serving_fixtures import (load_goldens, scenario_prompts,
                              scenario_requests)
from torch_port_fixtures import frontend, jax_params, port_arch, torch_params

# the reference's multi-device placement scenarios and their settings
CASES = {
    "tiny/base": dict(block_size=4, prefill_chunk=3),
    "hybrid/base": dict(block_size=4, prefill_chunk=4),
    "mla/base": dict(block_size=4, prefill_chunk=3),
    "hybrid/preempt": dict(block_size=4, num_blocks=8, prefill_chunk=8),
    "ssm/base": dict(block_size=4, prefill_chunk=3),
    "shared/base": dict(block_size=4, prefill_chunk=3),
    "shared/preempt": dict(block_size=4, num_blocks=8, prefill_chunk=8),
    "encdec/base": dict(block_size=4, prefill_chunk=3),
    "cross/base": dict(block_size=4, prefill_chunk=4),
}
# pool leaves sharded over `model` / pool leaves, as the reference's
# planner places them on (2, 2): the attention pools by KV heads, mamba2's
# conv_x and ssm by heads (conv_b and conv_c stay whole), zamba2's
# per-application pools, whisper's self and cross pools, llama-vision's
# cross slot rows
SPLIT = {"tiny/base": (2, 2), "hybrid/base": (4, 6), "mla/base": (0, 4),
         "hybrid/preempt": (4, 6), "ssm/base": (2, 4),
         "shared/base": (4, 6), "shared/preempt": (4, 6),
         "encdec/base": (4, 4), "cross/base": (4, 4)}
# how each (segment, block) runs on (2, 2): every block on its own share
# and pool shards (MLA's latent pools are replicated: every rank writes
# the same latents into its own whole copy); whisper's encoder block under
# ("encoder", segment, block)
BLOCK_FNS = {"tiny/base": {(0, 0): "tp_attn_block"},
             "hybrid/base": {(0, 0): "tp_attn_block",
                             (0, 1): "tp_mamba2_block"},
             "mla/base": {(0, 0): "tp_mla_block", (1, 0): "tp_mla_block"},
             "hybrid/preempt": {(0, 0): "tp_attn_block",
                                (0, 1): "tp_mamba2_block"},
             "ssm/base": {(0, 0): "tp_mamba2_block"},
             "shared/base": {(0, 0): "tp_shared_block",
                             (0, 1): "tp_mamba2_block"},
             "shared/preempt": {(0, 0): "tp_shared_block",
                                (0, 1): "tp_mamba2_block"},
             "encdec/base": {(0, 0): "tp_wdec_block",
                             ("encoder", 0, 0): "tp_attn_block"},
             "cross/base": {(0, 0): "tp_attn_block",
                            (0, 1): "tp_cross_block"}}


# 6 Q heads over 3 KV heads: on model = 2 wq and wo split, wk, wv and the
# pools stay whole, and each rank picks the KV heads of its Q heads ((0,
# 0, 1) and (1, 2, 2): not a range), which it reads and writes in a copy
GQA_ODD = JArchConfig(name="gqa-odd", family="dense", n_layers=2, d_model=96,
                      n_heads=6, n_kv_heads=3, head_dim=16, d_ff=128,
                      vocab=256, pattern=(JSegment(("attn",), 2),),
                      dtype="float32", param_dtype="float32")
GQA_ODD_CASE = dict(slots=2, max_len=64, engine=dict(block_size=4,
                                                     prefill_chunk=3),
                    requests=[(i, p, 6, None) for i, p in
                              enumerate(scenario_prompts(8, 4))])
# arctic's shape: GQA attention over KV heads that divide, 8 experts top 2
# (4 a rank on model = 2) and the dense residual FFN, capacity 1.25, so
# that prefill chunks drop tokens; served against the JAX engine and the
# unplaced one
TINY_MOE = JArchConfig(name="tiny-moe", family="moe", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab=256, moe=JMoESpec(n_experts=8, top_k=2, d_ff=32,
                                               dense_d_ff=64,
                                               capacity_factor=1.25),
                       pattern=(JSegment(("moe_attn",), 2),),
                       dtype="float32", param_dtype="float32")
TINY_MOE_CASE = dict(slots=2, max_len=64, engine=dict(block_size=4,
                                                      prefill_chunk=8),
                     requests=[(i, p, 6, None) for i, p in
                               enumerate(scenario_prompts(8, 4))])
# requests with frontends (seeded numpy, one a request) and the gates
# opened, held against the unplaced engine: whisper and llama-vision
FRONTEND_CASES = {"encdec/frontend": "encdec/base",
                  "cross/frontend": "cross/base"}


def _frontend_case(name: str) -> dict:
    scenario = FRONTEND_CASES[name]
    arch, reqs, slots, max_len = scenario_requests(scenario)
    fes = frontend(arch, len(reqs), 11)
    return dict(slots=slots, max_len=max_len, engine=CASES[scenario],
                requests=[(rid, p, m, fes[rid:rid + 1])
                          for rid, p, m in reqs])


@pytest.fixture(scope="module", autouse=True)
def _world_of_one():
    """A world of 1 in this process for the single-rank tests, torn down
    after the module; tiny tensors, one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    M.shutdown()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def four_ranks():
    d = pathlib.Path(tempfile.mkdtemp())
    cases = {}
    for name, kw in CASES.items():
        arch, reqs, slots, max_len = scenario_requests(name)
        cases[name] = dict(
            arch=port_arch(arch), slots=slots, max_len=max_len, engine=kw,
            params=jax.tree.map(np.asarray, jax_params(arch)),
            requests=[(rid, p, m, None) for rid, p, m in reqs])
    cases["gqa-odd"] = dict(GQA_ODD_CASE, arch=port_arch(GQA_ODD),
                            params=jax.tree.map(np.asarray,
                                                jax_params(GQA_ODD)))
    cases["tiny-moe"] = dict(TINY_MOE_CASE, arch=port_arch(TINY_MOE),
                             params=jax.tree.map(np.asarray,
                                                 jax_params(TINY_MOE)))
    cases["tiny-moe/ep"] = dict(cases["tiny-moe"], moe_ep=True)
    for name, scenario in FRONTEND_CASES.items():
        arch = scenario_requests(scenario)[0]
        cases[name] = dict(_frontend_case(name), arch=port_arch(arch),
                           params=jax.tree.map(np.asarray, jax_params(
                               arch, open_gates=True)))
    (d / "in.pkl").write_bytes(pickle.dumps(cases))
    t0 = time.perf_counter()
    mp.start_processes(W.run, args=(4, str(d / "store"), str(d / "in.pkl"),
                                    str(d / "out.pkl")),
                       nprocs=4, start_method="spawn")
    res = pickle.loads((d / "out.pkl").read_bytes())
    res["seconds"] = time.perf_counter() - t0
    return res


@pytest.mark.parametrize("scenario", list(CASES))
def test_four_ranks_serve_the_goldens(four_ranks, scenario):
    got = four_ranks[scenario]
    assert got["tokens"] == load_goldens(scenario), scenario
    assert four_ranks["ranks_agree"]
    assert got["blocks_used"] == 0
    assert (got["preemptions"] > 0) == scenario.endswith("preempt")


@pytest.mark.parametrize("scenario", list(CASES))
def test_four_ranks_place_pools_by_the_plan(four_ranks, scenario):
    got = four_ranks[scenario]
    assert got["n_pool_leaves"] == len(got["specs"])
    assert all(got["placed_as_specs"]), got["specs"]
    split = [s for s in got["specs"] if "model" in s]
    assert (len(split), len(got["specs"])) == SPLIT[scenario]
    # a split leaf holds half its heads on each `model` rank
    for spec, full, local in zip(got["specs"], got["pool_shapes"],
                                 got["local_pool_shapes"]):
        want = list(full)
        if "model" in spec:
            want[spec.index("model")] //= 2
        assert list(local) == want, (spec, full, local)
    assert got["block_fns"] == BLOCK_FNS[scenario]


@pytest.mark.parametrize("scenario", list(CASES))
def test_four_ranks_plan_is_the_reference_planners(four_ranks, scenario):
    arch, _, slots, max_len = scenario_requests(scenario)
    ref = JAdaptiveScheduler(faithful=False).plan(
        arch, JShapeSpec("serve", max_len, slots, "decode"),
        JMeshShape(data=2, model=2))
    got = four_ranks[scenario]
    assert got["assignment"] == {k: str(v)
                                 for k, v in ref.assignment.items()}
    assert got["method"] == ref.plan.method
    assert four_ranks["seconds"] < 120


def test_four_ranks_pick_kv_heads_that_do_not_divide(four_ranks):
    got = four_ranks["gqa-odd"]
    eng = ContinuousBatchingEngine(
        port_arch(GQA_ODD), torch_params(GQA_ODD), device="cpu",
        slots=GQA_ODD_CASE["slots"], max_len=GQA_ODD_CASE["max_len"],
        **GQA_ODD_CASE["engine"])
    outs = eng.generate([Request(id=rid, prompt=p.copy(), max_new_tokens=m)
                         for rid, p, m, _ in GQA_ODD_CASE["requests"]])
    assert got["tokens"] == {o.request_id: o.token_ids for o in outs}
    assert got["block_fns"] == {(0, 0): "tp_attn_block"}
    assert got["specs"] == [(), ()] and all(got["placed_as_specs"])


def _jax_tokens(arch, case, open_gates=False) -> dict:
    """The JAX engine's greedy tokens for a case, on the same params (with
    ``open_gates``, the gates opened), frontends and engine settings."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    eng = JaxEngine(arch, jax_params(arch, open_gates=open_gates),
                    make_host_mesh(), slots=case["slots"],
                    max_len=case["max_len"], **case["engine"])
    outs = eng.generate([JaxRequest(id=rid, prompt=p.copy(),
                                    max_new_tokens=m, frontend=fe)
                         for rid, p, m, fe in case["requests"]])
    return {o.request_id: list(o.token_ids) for o in outs}


def test_four_ranks_serve_experts_like_one(four_ranks):
    """tiny-moe placed on (2, 2): its attention by heads and its experts
    by ranges, the dense FFN by d_ff, give the JAX engine's tokens on the
    same params and settings (its prefill chunks drop tokens), and the
    unplaced engine's."""
    got = four_ranks["tiny-moe"]
    assert {k: list(v) for k, v in got["tokens"].items()} == \
        _jax_tokens(TINY_MOE, TINY_MOE_CASE)
    eng = ContinuousBatchingEngine(
        port_arch(TINY_MOE), torch_params(TINY_MOE), device="cpu",
        slots=TINY_MOE_CASE["slots"], max_len=TINY_MOE_CASE["max_len"],
        **TINY_MOE_CASE["engine"])
    outs = eng.generate([Request(id=rid, prompt=p.copy(), max_new_tokens=m)
                         for rid, p, m, _ in TINY_MOE_CASE["requests"]])
    assert got["tokens"] == {o.request_id: o.token_ids for o in outs}
    assert got["block_fns"] == {(0, 0): "tp_attn_block"}
    assert got["experts"] == {4}


def test_four_ranks_serve_ep_major_experts_like_one(four_ranks):
    """tiny-moe placed on (2, 2) under the EP-major layout (experts over
    `data`, their FF dim over `model`): every rank holds the same rows,
    so each runs its `data` range of experts with its `model` slice of F
    on every row and one all-reduce over the world sums the parts; the
    tokens are the ones ``test_four_ranks_serve_experts_like_one``
    holds, and every rank's."""
    got = four_ranks["tiny-moe/ep"]
    assert got["tokens"] == four_ranks["tiny-moe"]["tokens"]
    assert {k: list(v) for k, v in got["tokens"].items()} == \
        _jax_tokens(TINY_MOE, TINY_MOE_CASE)
    assert four_ranks["ranks_agree"]
    assert got["block_fns"] == {(0, 0): "tp_attn_block"}
    assert got["stack_specs"] == {(None, "data", None, "model"),
                                  (None, "data", "model", None)}
    E, F = TINY_MOE.moe.n_experts, TINY_MOE.moe.d_ff
    assert got["stacks"] == {(E // 2, TINY_MOE.d_model, F // 2)}


@pytest.mark.parametrize("name", list(FRONTEND_CASES))
def test_four_ranks_serve_frontends_like_one(four_ranks, name):
    """Requests with frontends, gates opened: the placed engine on (2, 2)
    gives the JAX engine's tokens on the same params and frontends, and
    the unplaced engine's, its blocks on their own heads."""
    scenario = FRONTEND_CASES[name]
    arch = scenario_requests(scenario)[0]
    case = _frontend_case(name)
    got = four_ranks[name]
    assert {k: list(v) for k, v in got["tokens"].items()} == \
        _jax_tokens(arch, case, open_gates=True)
    eng = ContinuousBatchingEngine(
        port_arch(arch), torch_params(arch, open_gates=True), device="cpu",
        slots=case["slots"], max_len=case["max_len"], **case["engine"])
    outs = eng.generate([Request(id=rid, prompt=p.copy(), max_new_tokens=m,
                                 frontend=fe)
                         for rid, p, m, fe in case["requests"]])
    assert got["tokens"] == {o.request_id: o.token_ids for o in outs}
    assert got["block_fns"] == BLOCK_FNS[scenario]


def _serve(scenario, mesh, sampling=None):
    arch, reqs, slots, max_len = scenario_requests(scenario)
    eng = ContinuousBatchingEngine(
        port_arch(arch), torch_params(arch), mesh,
        device="cpu" if mesh is None else None, slots=slots,
        max_len=max_len, **CASES[scenario])
    sp = sampling or SamplingParams(logprobs=True)
    outs = eng.generate([Request(id=rid, prompt=p.copy(), max_new_tokens=m,
                                 sampling=sp) for rid, p, m in reqs])
    return eng, {o.request_id: (o.token_ids, o.logprobs) for o in outs}


@pytest.mark.parametrize("scenario", ["tiny/base", "hybrid/base"])
def test_world_of_one_placed_engine_is_the_unplaced_one(scenario):
    mesh = M.make_host_mesh(device="cpu")
    sampled = SamplingParams(temperature=0.8, top_p=0.9, seed=3,
                             logprobs=True)
    for sp in (None, sampled):
        plain, want = _serve(scenario, None, sp)
        placed, got = _serve(scenario, mesh, sp)
        assert got == want                 # tokens and logprobs, bit for bit
    assert plain.plan.assignment == placed.plan.assignment
    leaf = placed.params["embed"]["embedding"]
    assert type(leaf).__name__ == "DTensor" and leaf.device_mesh is mesh
    assert all(type(x).__name__ == "DTensor"
               for seg in placed.cache.pools for b in seg.values()
               for x in b.values())
    assert placed.device == torch.device("cpu")


def test_server_plan_is_the_engines():
    from repro_torch.core.asa import AdaptiveScheduler
    from repro_torch.runtime.server import Server
    arch, reqs, slots, max_len = scenario_requests("tiny/base")
    mesh = M.make_host_mesh(device="cpu")
    asa = AdaptiveScheduler(faithful=False)
    with pytest.deprecated_call():
        srv = Server(port_arch(arch), torch_params(arch), mesh, slots=slots,
                     max_len=max_len, scheduler=asa, block_size=4,
                     prefill_chunk=3)
    assert srv.plan is srv.engine.plan
    assert srv.engine._asa is asa
    assert srv.plan.shape.kind == "decode" and srv.plan.shape.seq_len == \
        max_len

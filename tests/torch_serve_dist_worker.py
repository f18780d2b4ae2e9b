"""The four-rank side of ``tests/test_torch_placed_serving.py``: spawned once
per test module, each rank joins a gloo group through a file store, builds
the placed engine on a (data 2, model 2) mesh for every case the parent
pickled (the port's arch, the reference's params as numpy, the requests,
each with its frontend or None, and the engine's settings) and serves it;
rank 0 pickles the results.
Imports torch, numpy and the port only (no JAX)."""
from __future__ import annotations

import pickle
from unittest import mock

import torch
import torch.distributed as dist

from repro_torch import convert, tree
from repro_torch.core import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
from repro_torch.serving.engine import ContinuousBatchingEngine, Request


def serve(mesh, case: dict) -> dict:
    eng = ContinuousBatchingEngine(
        case["arch"], convert.to_torch(case["params"]), mesh,
        slots=case["slots"], max_len=case["max_len"], **case["engine"])
    specs = SH.spec_leaves(eng.plan.paged_cache_specs())
    pools = tree.leaves(eng.cache.pools)
    experts, routed = set(), MOE.routed

    def routed_(p, *a, **k):
        experts.add(p["w_in"].shape[0])
        return routed(p, *a, **k)
    with mock.patch.object(MOE, "routed", routed_):
        outs = eng.generate([Request(id=rid, prompt=p.copy(),
                                     max_new_tokens=m, frontend=fe)
                             for rid, p, m, fe in case["requests"]])
    return dict(
        # the experts of each MoE layer's working stacks
        experts=experts,
        tokens={o.request_id: o.token_ids for o in outs},
        logprobs={o.request_id: o.logprobs for o in outs},
        n_pool_leaves=len(pools),
        specs=[tuple(s) for s in specs],
        # each pool leaf's placements against its spec's on this mesh
        placed_as_specs=[x.placements == SH.placements(s, mesh)
                         for x, s in zip(pools, specs)],
        local_pool_shapes=[tuple(x.to_local().shape) for x in pools],
        pool_shapes=[tuple(x.shape) for x in pools],
        assignment={k: str(v) for k, v in eng.plan.assignment.items()},
        method=eng.plan.plan.method,
        # how each block runs: a tensor-parallel block ("tp_attn_block",
        # "tp_mamba2_block", ...: its own share) or "_gathered_block" (pool
        # shards gathered around the call); the encoder's under
        # ("encoder", segment, block)
        block_fns={(si, bi) if si != "encoder" else ("encoder",) + key:
                   fn.__qualname__.split(".")[0]
                   for si, fns in (eng._placed.block_fns or {}).items()
                   for key, fn in _flat(fns)
                   for bi in [key]},
        preemptions=eng.metrics.preemptions,
        blocks_used=eng.cache.allocator.num_used)


def _flat(fns: dict, prefix=()):
    """(key path, fn) of a nested {index: fn or {index: fn}} dict."""
    for k, v in fns.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield (prefix + (k,) if prefix else k), v


def run(rank: int, world: int, store: str, inp: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    mesh = make_host_mesh(model=2, device="cpu")
    res = {name: serve(mesh, case) for name, case in cases.items()}
    # every rank must have sampled the same tokens
    every = [None] * world
    dist.all_gather_object(every, {k: v["tokens"] for k, v in res.items()})
    res["ranks_agree"] = all(e == every[0] for e in every)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()

"""The four-rank side of ``tests/test_torch_distributed.py``: spawned
once per test module, each rank joins a gloo group through a file store
and runs every case; rank 0 pickles the results for the test.  Imports
torch and the port only (no JAX), so the ranks start fast."""
from __future__ import annotations

import pickle
import tempfile

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, Segment, ShapeSpec
from repro_torch.core import solver as SV
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.core.strategy import Strategy
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.trainer import TrainConfig, Trainer

# test_convergence_parity.py's arch (4 heads, 4 KV heads) and test_runtime's
# tiny-rt (4 heads over 2 KV heads: on model = 4 the KV projections stay
# replicated and each rank picks the KV head of its Q head)
ARCHS = {
    "parity": ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                         pattern=(Segment(("attn",), 2),), dtype="float32",
                         param_dtype="float32"),
    "tiny-rt": ArchConfig(name="tiny-rt", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab=256, pattern=(Segment(("attn",), 2),),
                          dtype="float32", param_dtype="float32")}
SHAPE = ShapeSpec("dist", 32, 8, "train")
CFG = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=40)
STEPS = 4
# (case, strategy or None for the ASA's own plan, model axis)
CASES = (("DP", "DP", 1), ("MP", "MP", 4), ("HP", "HP", 2), ("FS", "FS", 2),
         ("ASA", None, 2))


class Uniform(AdaptiveScheduler):
    """A scheduler whose plan is one strategy everywhere (the baseline the
    reference's ``solve_uniform`` builds), one microbatch."""

    def __init__(self, strategy: str):
        super().__init__()
        self.strategy = Strategy(strategy)

    def plan(self, arch, shape, mesh):
        sp = super().plan(arch, shape, mesh)
        cm = self._cost_model(mesh, shape.kind)
        sp.plan = SV.solve_uniform(cm, sp.comps, self.strategy)
        sp.microbatches = 1
        return sp


def scheduler(strategy):
    return AdaptiveScheduler(faithful=False) if strategy is None \
        else Uniform(strategy)


def train(arch, mesh, strategy, *, quantized=False, steps=STEPS):
    import dataclasses
    cfg = dataclasses.replace(CFG, quantized_opt=quantized)
    tr = Trainer(arch, SHAPE, mesh, cfg, scheduler=scheduler(strategy))
    p, o = tr.init_state()
    p, o, hist = tr.train(p, o, SyntheticLM(arch.vocab, 32, 8), steps=steps)
    return tr, p, o, [m["loss"] for m in hist]


def shard_mismatches(tr, params) -> list:
    """Leaves whose local shard is not the global shape divided by the
    mesh axes its spec names."""
    sizes = dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape))
    bad = []
    for name, p, ns in zip(tree.names(params), tree.leaves(params),
                           tree.leaves(tr._pns)):
        want = list(p.shape)
        for d, ax in enumerate(ns.spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    want[d] //= sizes[a]
        if list(p.to_local().shape) != want:
            bad.append((name, tuple(ns.spec), tuple(p.to_local().shape)))
    return bad


def run(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {"losses": {}, "methods": {}, "shards": {}, "sharded": {}}
    for name, arch in ARCHS.items():
        for case, strategy, model in CASES:
            mesh = make_host_mesh(model=model, device="cpu")
            tr, p, o, losses = train(arch, mesh, strategy)
            res["losses"][(name, case)] = losses
            res["methods"][(name, case)] = tr.plan.plan.method
            res["shards"][(name, case)] = shard_mismatches(tr, p)
            wq = p["segments"][0]["b0"]["attn"]["wq"]["w"]
            res["sharded"][(name, case)] = (tuple(wq.shape),
                                            tuple(wq.to_local().shape))
    # int8 moments on (2, 2) under HP (3 steps: at this lr the int8
    # moments' zeroed small entries blow the fourth step up, on one rank
    # as on four, so that a rounding apart decides its value)
    mesh = make_host_mesh(model=2, device="cpu")
    res["losses"][("tiny-rt", "HP-int8")] = train(
        ARCHS["tiny-rt"], mesh, "HP", quantized=True, steps=3)[3]
    # a checkpoint saved on (4, 1) under HP restores onto (2, 2)
    ck = [tempfile.mkdtemp() if rank == 0 else None]
    dist.broadcast_object_list(ck)
    arch = ARCHS["tiny-rt"]
    tr = Trainer(arch, SHAPE, make_host_mesh(model=1, device="cpu"), CFG,
                 scheduler=Uniform("HP"), checkpoint_dir=ck[0])
    p, o = tr.init_state()
    p, o, _ = tr.train(p, o, SyntheticLM(arch.vocab, 32, 8), steps=2)
    tr.ckpt.save(tr.step, {"params": p, "opt": o},
                 extra={"data_offset": tr.data_offset})
    tr.ckpt.wait()
    saved = [x.full_tensor() for x in tree.leaves(p)]
    saved_mu = [x.full_tensor() for x in tree.leaves(o.mu)]
    tr2 = Trainer(arch, SHAPE, make_host_mesh(model=2, device="cpu"), CFG,
                  scheduler=Uniform("HP"), checkpoint_dir=ck[0])
    p2, o2 = tr2.init_state(seed=1)
    p2, o2 = tr2.maybe_restore(p2, o2)
    got = [x.full_tensor() for x in tree.leaves(p2)]
    got_mu = [x.full_tensor() for x in tree.leaves(o2.mu)]
    res["reshard"] = dict(
        step=tr2.step, placements=[str(x.placements) for x in
                                   tree.leaves(p2)][:3],
        params_equal=all(torch.equal(a, b) for a, b in zip(saved, got)),
        mu_equal=all(torch.equal(a, b) for a, b in zip(saved_mu, got_mu)),
        local_shapes=[tuple(x.to_local().shape) for x in tree.leaves(p2)])
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()

"""The four-rank side of ``tests/test_torch_distributed.py``: spawned
once per test module for the dense archs and the checkpoint (``run``),
once for the archs whose other block kinds run tensor-parallel
(``run_tp``) and once for the MoE family's (``run_moe``), each rank joins
a gloo group through a file store and runs every case; rank 0 pickles
the results for the test.  Imports torch,
numpy and the port only (no JAX), so the ranks start fast."""
from __future__ import annotations

import contextlib
import pickle
import tempfile
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import (ArchConfig, EncoderSpec, MLASpec,
                                      MoESpec, Segment, ShapeSpec, SSMSpec)
from repro_torch.core import solver as SV
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.core.strategy import Strategy
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.trainer import TrainConfig, Trainer

# test_convergence_parity.py's arch (4 heads, 4 KV heads) and test_runtime's
# tiny-rt (4 heads over 2 KV heads: on model = 4 the KV projections stay
# replicated and each rank picks the KV head of its Q head); then copies of
# tests/serving_fixtures.py's tiny configs of the kinds that run
# tensor-parallel beside attn (fp32, scan chunks of 16 or less): mamba2 (8
# heads: 2 a rank on model 4), mamba2 over two B/C groups (model 4: a
# rank's 2 heads within one group; model 2: a whole group a rank), zamba2's
# shared block with mamba2, whisper's encoder and wdec decoder, and
# llama-vision's attn with gated cross attention (4 heads over 2 KV heads:
# picked on model 4); then the MoE family: deepseek's shape at TINY_MLA's
# widths (latent attention, 8 experts top 2 behind a sigmoid router, one
# shared expert, the MTP head) and arctic's (GQA 4 over 2, 8 experts top 2
# behind a softmax router, the dense residual FFN; capacity 1.25, so that
# tokens are dropped across the expert split)
_SSM = dict(family="ssm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=128, vocab=256, pattern=(Segment(("mamba2",), 2),),
            dtype="float32", param_dtype="float32")
ARCHS = {
    "parity": ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                         pattern=(Segment(("attn",), 2),), dtype="float32",
                         param_dtype="float32"),
    "tiny-rt": ArchConfig(name="tiny-rt", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab=256, pattern=(Segment(("attn",), 2),),
                          dtype="float32", param_dtype="float32"),
    "tiny-ssm": ArchConfig(name="tiny-ssm", **_SSM, ssm=SSMSpec(
        d_state=16, head_dim=16, chunk=16)),
    "tiny-ssm-g2": ArchConfig(name="tiny-ssm-g2", **_SSM, ssm=SSMSpec(
        d_state=16, head_dim=16, n_groups=2, chunk=4)),
    "tiny-shared": ArchConfig(
        name="tiny-shared", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, act="geglu",
        tie_embeddings=True, ssm=SSMSpec(d_state=16, head_dim=16, d_conv=4,
                                         chunk=4),
        pattern=(Segment(("shared_attn", "mamba2"), 2),), dtype="float32",
        param_dtype="float32"),
    "tiny-encdec": ArchConfig(
        name="tiny-encdec", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, act="gelu",
        norm="layernorm", attn_bias=True, tie_embeddings=True,
        pattern=(Segment(("wdec",), 2),),
        encoder=EncoderSpec(n_layers=2, seq_len=8, d_ff=128),
        frontend="audio", dtype="float32", param_dtype="float32"),
    "tiny-cross": ArchConfig(
        name="tiny-cross", family="vlm", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, frontend="vision",
        n_img_tokens=8, pattern=(Segment(("attn", "cross_attn"), 2),),
        dtype="float32", param_dtype="float32"),
    "tiny-mla-ep": ArchConfig(
        name="tiny-mla-ep", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        mla=MLASpec(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16),
        moe=MoESpec(n_experts=8, top_k=2, d_ff=32, router="sigmoid",
                    n_shared_experts=1, capacity_factor=2.0),
        mtp=True, pattern=(Segment(("mla_dense",), 1),
                           Segment(("mla",), 1)),
        dtype="float32", param_dtype="float32"),
    "tiny-moe": ArchConfig(
        name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256,
        moe=MoESpec(n_experts=8, top_k=2, d_ff=32, dense_d_ff=64,
                    capacity_factor=1.25),
        pattern=(Segment(("moe_attn",), 2),), dtype="float32",
        param_dtype="float32")}
# the leaf each arch's storage check reads (sharded over `model` under MP)
PROBE = {"parity": "segments.0.b0.attn.wq.w",
         "tiny-rt": "segments.0.b0.attn.wq.w",
         "tiny-ssm": "segments.0.b0.mixer.x_proj.w",
         "tiny-ssm-g2": "segments.0.b0.mixer.x_proj.w",
         "tiny-shared": "shared.attn.wq.w",
         "tiny-encdec": "segments.0.b0.xattn.wq.w",
         "tiny-cross": "segments.0.b1.attn.wq.w",
         "tiny-mla-ep": "segments.1.b0.attn.wq_b.w",
         "tiny-moe": "segments.0.b0.moe.w_in"}
SHAPE = ShapeSpec("dist", 32, 8, "train")
CFG = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=40)
STEPS = 4
# the tensor-parallel kinds' archs: 2 steps each (step 2's loss and grad
# norm follow step 1's gradients), so that their spawn stays as cheap as
# the dense one
TP_ARCHS = ("tiny-ssm", "tiny-ssm-g2", "tiny-shared", "tiny-encdec",
            "tiny-cross", "tiny-mla-ep", "tiny-moe")
TP_STEPS = 2
# the MoE family's archs, spawned on their own (``run_moe``) so that each
# spawn stays as cheap as the dense one; every step-1 gradient of theirs
# under MP and HP is held leaf by leaf
MOE_ARCHS = ("tiny-mla-ep", "tiny-moe")
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


def data(arch):
    """SyntheticLM(arch.vocab, 32, 8) batches; an arch with a frontend
    gets its own (8, T, d_model) N(0, 1) embeddings in each, from numpy
    seeded by the step, so every rank and the JAX step see the same."""
    for i, batch in enumerate(SyntheticLM(arch.vocab, 32, 8)):
        if arch.frontend:
            T = arch.encoder.seq_len if arch.encoder else arch.n_img_tokens
            batch["frontend"] = np.random.default_rng(100 + i) \
                .standard_normal((8, T, arch.d_model)).astype(np.float32)
        yield batch


def train(arch, mesh, strategy, *, quantized=False, steps=STEPS):
    import dataclasses
    cfg = dataclasses.replace(CFG, quantized_opt=quantized)
    tr = Trainer(arch, SHAPE, mesh, cfg, scheduler=scheduler(strategy))
    p, o = tr.init_state()
    p, o, hist = tr.train(p, o, data(arch), steps=steps)
    tr.grad_norms = [m["grad_norm"] for m in hist]
    return tr, p, o, [m["loss"] for m in hist]


@contextlib.contextmanager
def recording(rec: dict):
    """Record what the step computes on this rank: the heads of every
    ``ssd_scan`` call, the working width of x_proj in every mamba2 mixer
    and of wq in every attention (by its d_model), the heads of every
    latent attention, the experts of every MoE layer's stacks and the
    assignments its capacity drops (over all E experts), and the leaves
    whose working tensor is all-gathered over `model`."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE
    from repro_torch.runtime import sharded as SD
    rec.update(ssd_heads=set(), x_proj=set(), wq=set(), mla_heads=set(),
               experts=set(), dropped=0, gathered_over_model=set())
    scan, mixer, attention = ops.ssd_scan, B.mamba2_mixer, L.attention
    attend, routed = MLA._attend, MOE.routed
    working = SD.working_tree

    def attend_(cfg, q_nope, *a, **k):
        rec["mla_heads"].add(q_nope.shape[2])
        return attend(cfg, q_nope, *a, **k)

    def routed_(p, cfg, x, *a, **k):
        rec["experts"].add(p["w_in"].shape[0])
        _, _, idx = MOE.route(p, cfg, x)
        C = max(1, int(cfg.capacity_factor * cfg.top_k * x.shape[1]
                       / cfg.n_experts))
        count = torch.nn.functional.one_hot(idx, cfg.n_experts).sum((1, 2))
        rec["dropped"] += int((count - C).clamp_min(0).sum())
        return routed(p, cfg, x, *a, **k)

    def scan_(x, *a, **k):
        rec["ssd_heads"].add(x.shape[2])
        return scan(x, *a, **k)

    def mixer_(p, *a, **k):
        rec["x_proj"].add(tuple(p["x_proj"]["w"].shape))
        return mixer(p, *a, **k)

    def attention_(p, cfg, *a, **k):
        rec["wq"].add((cfg.d_model, tuple(p["wq"]["w"].shape)))
        return attention(p, cfg, *a, **k)

    def working_(params, live, lays, mesh):
        mdim = tuple(mesh.mesh_dim_names).index("model")
        for name, lay in zip(tree.names(params), lays):
            want = SD._Working(lay, mesh, mdim).want
            if type(lay.placements[mdim]).__name__ == "Shard" and \
                    type(want[mdim]).__name__ == "Replicate":
                rec["gathered_over_model"].add(name)
        return working(params, live, lays, mesh)
    with mock.patch.object(ops, "ssd_scan", scan_), \
            mock.patch.object(B, "mamba2_mixer", mixer_), \
            mock.patch.object(L, "attention", attention_), \
            mock.patch.object(MLA, "_attend", attend_), \
            mock.patch.object(MOE, "routed", routed_), \
            mock.patch.object(SD, "working_tree", working_):
        yield


def gathers_by_hand() -> list:
    """``sharded._gather_dims`` (the sharded step's all-gather) against
    DTensor's redistribute on a (2, 2) mesh, for shards of one (8, 12)
    tensor: whole, and the `model` shard kept where that is a gather (a
    tensor dim sharded over both mesh dims is not: the call refuses it)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharded as SD
    mesh = make_host_mesh(model=2, device="cpu")
    full = torch.arange(96.0).reshape(8, 12)
    R = Replicate()
    out = []
    for have in ((Shard(0), Shard(1)), (Shard(0), Shard(0)), (R, Shard(1)),
                 (Shard(1), R), (Shard(1), Shard(1))):
        local = SH.shard_of(full, mesh, have).contiguous()
        for want in ((R, R), (R, have[1])):
            if have[0] == have[1] == want[1]:
                try:
                    SD._gather_dims(local, mesh, have, want)
                    out.append((str(have), str(want), False))
                except ValueError:
                    out.append((str(have), str(want), True))
                continue
            got = SD._gather_dims(local, mesh, have, want)
            ref = SD._dt().DTensor.from_local(local, mesh, have,
                                              run_check=False) \
                .redistribute(mesh, want).to_local()
            out.append((str(have), str(want), torch.equal(got, ref)))
    return out


def split_rmsnorm(rank: int, world: int) -> dict:
    """The split-row RMSNorm over the world's ranks: each rank its quarter
    of the columns of one (6, 40) fp32 x and scale, the loss sum(y * w);
    -> this rank's y, dx and dscale (the whole row's in the test)."""
    from repro_torch.kernels import rmsnorm as RN
    rng = np.random.default_rng(3)
    x, w = (torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
            for _ in range(2))
    scale = torch.from_numpy(
        (1 + 0.1 * rng.standard_normal(40)).astype(np.float32))
    cols = slice(rank * 40 // world, (rank + 1) * 40 // world)
    xl = x[:, cols].contiguous().requires_grad_()
    sl = scale[cols].contiguous().requires_grad_()
    y = RN.rmsnorm_split(xl, sl, d_total=40, group=dist.group.WORLD)
    torch.sum(y * w[:, cols]).backward()
    return dict(y=y.detach().numpy(), dx=xl.grad.numpy(),
                dscale=sl.grad.numpy())


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


def train_all(names, steps: int, world: int) -> dict:
    """Every case of each arch of ``names``, ``steps`` steps: losses, grad
    norms, plan methods, shard shapes; under MP what each rank computes
    (``recording``)."""
    res = {"losses": {}, "grad_norms": {}, "methods": {}, "shards": {},
           "sharded": {}, "split": {}}
    for name in names:
        arch = ARCHS[name]
        for case, strategy, model in CASES:
            mesh = make_host_mesh(model=model, device="cpu")
            rec = {}
            with (recording(rec) if case == "MP" else
                  contextlib.nullcontext()):
                tr, p, o, losses = train(arch, mesh, strategy, steps=steps)
            res["losses"][(name, case)] = losses
            res["grad_norms"][(name, case)] = tr.grad_norms
            res["methods"][(name, case)] = tr.plan.plan.method
            res["shards"][(name, case)] = shard_mismatches(tr, p)
            probe = dict(zip(tree.names(p), tree.leaves(p)))[PROBE[name]]
            res["sharded"][(name, case)] = (tuple(probe.shape),
                                            tuple(probe.to_local().shape))
            if rec:
                every = [None] * world
                dist.all_gather_object(every, rec)
                res["split"][name] = every
    return res


def step1_grads(name: str, strategy: str, model: int) -> dict:
    """Step 1's gradient of every leaf of arch ``name`` under ``strategy``
    on (world / ``model``, ``model``), reduced to its placement by the
    sharded step (an optimizer that keeps the grads and updates nothing)
    and gathered whole: {leaf name: array}."""
    from repro_torch.runtime import sharded as SD
    from repro_torch.runtime import steps as ST
    arch = ARCHS[name]
    mesh = make_host_mesh(model=model, device="cpu")
    tr = Trainer(arch, SHAPE, mesh, CFG, scheduler=Uniform(strategy))
    p, o = tr.init_state()
    kept = {}

    def keep(grads, state, params):
        kept["g"] = tree.leaves(grads)
        return tree.map(torch.zeros_like, grads), state
    step = ST.make_train_step(arch, (None, keep), act_sharding=tr._specs()[2],
                              grad_shardings=tr._pns,
                              clip_norm=float("inf"))
    step(p, o, next(data(arch)))
    return {leaf: SD.gather_full(g, mesh, ns.placements).numpy()
            for leaf, g, ns in zip(tree.names(p), kept["g"],
                                   tree.leaves(tr._pns))}


def run_moe(rank: int, world: int, store: str, out: str) -> None:
    """The MoE family's archs (``MOE_ARCHS``) and their step-1 gradients
    under MP on (1, 4) and HP on (2, 2)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = train_all(MOE_ARCHS, TP_STEPS, world)
    res["mp_grads"] = {name: step1_grads(name, "MP", world)
                       for name in MOE_ARCHS}
    res["hp_grads"] = {name: step1_grads(name, "HP", 2)
                       for name in MOE_ARCHS}
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


def run_tp(rank: int, world: int, store: str, out: str) -> None:
    """The other tensor-parallel kinds' archs (``TP_ARCHS`` but
    ``MOE_ARCHS``), the gathers by hand and the split-row RMSNorm."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = train_all([n for n in TP_ARCHS if n not in MOE_ARCHS], TP_STEPS,
                    world)
    res["gathers_by_hand"] = gathers_by_hand()
    res["split_rmsnorm"] = [None] * world
    dist.all_gather_object(res["split_rmsnorm"], split_rmsnorm(rank, world))
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


def run(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = train_all([n for n in ARCHS if n not in TP_ARCHS], STEPS, world)
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
    p, o, _ = tr.train(p, o, data(arch), steps=2)
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

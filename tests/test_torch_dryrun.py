"""The PyTorch port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``, on the CPU: model FLOPs and shape
applicability for every cell, the plan meta of three cells, one cell run
end to end on a fake group of 256 ranks in a subprocess (its all-gather
and all-reduce bytes against a count made from the plan's specs), and
``--moe-ep``: the plan, meta and expert specs of two MoE cells equal the
reference's ``AdaptiveScheduler(moe_ep=True)`` ones, a dense arch's are
unchanged, and a depth-cut deepseek-v3-671b decode cell records the
all-to-alls its specs give.  Exact equality throughout: planning is
host arithmetic on both sides.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import resource
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import shape_applicable as j_applicable
from repro.core.asa import AdaptiveScheduler as JScheduler
from repro.core.costmodel import MeshShape as JMesh
from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.core import components as C
from repro_torch.core import sharding as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import sharded as SD

REPO = pathlib.Path(__file__).resolve().parents[1]
# a cell's shapes-only run stays far below the model it describes
# (qwen3-8b: 16 GB of bf16 weights)
MAX_RSS_BYTES = 4 << 30


def smoke_cost() -> dict:
    """chip_smoke.py's ``DRYRUN_CPU_COST``: each of its dry-run cells'
    counted cost with fake CPU tensors."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.DRYRUN_CPU_COST


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the process's XLA_FLAGS
    kept: the module sets them for itself on import."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as RD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return RD


def test_model_flops_and_applicability_match_reference():
    RD = _reference_dryrun()
    assert sorted(ARCHS) == sorted(J_ARCHS)
    assert sorted(SHAPES) == sorted(J_SHAPES)
    for a in ARCHS:
        for s in SHAPES:
            assert DR.model_flops(a, s) == RD.model_flops(a, s), (a, s)
            assert shape_applicable(ARCHS[a], SHAPES[s]) == \
                j_applicable(J_ARCHS[a], J_SHAPES[s]), (a, s)


CELLS = [("qwen3-8b", "train_4k", False, False, False),
         ("deepseek-v3-671b", "decode_32k", False, False, False),
         ("command-r-plus-104b", "prefill_32k", True, True, True)]


@pytest.mark.parametrize("arch,shape,multi_pod,seq_shard,opt8bit", CELLS)
def test_plan_meta_matches_reference(arch, shape, multi_pod, seq_shard,
                                     opt8bit):
    """``plan_cell``'s meta equals the reference's ``AdaptiveScheduler``
    plan made with ``build_cell``'s arguments."""
    _, meta, _ = DR.plan_cell(arch, shape, multi_pod=multi_pod,
                              seq_shard=seq_shard, opt8bit=opt8bit)
    ja, js = J_ARCHS[arch], J_SHAPES[shape]
    ms = JMesh(16, 16, pod=2 if multi_pod else 1)
    preset = ("adamw8bit" if arch in DR.QUANTIZED_OPT or opt8bit
              else "adamw32")
    seq_ok = (seq_shard and ja.family not in ("ssm", "hybrid")
              and js.kind != "decode" and js.seq_len % ms.model == 0)
    plan = JScheduler(faithful=False, opt_preset=preset, remat="full",
                      seq_sharded=seq_ok, moe_ep=False).plan(ja, js, ms)
    assert meta == {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16", "opt_preset": preset,
        "microbatches": plan.microbatches, "seq_shard": seq_ok,
        "method": plan.plan.method, "feasible": plan.plan.feasible,
        "predicted": plan.plan.cost,
        "assignment": {k: str(v) for k, v in plan.assignment.items()}}


def _axes_size(ax) -> int:
    sizes = {"data": 16, "model": 16, "pod": 1}
    n = 1
    for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return n


def _shards(spec) -> int:
    n = 1
    for ax in spec:
        n *= _axes_size(ax)
    return n


def _roles(arch, shape) -> dict:
    """``plan_layout``'s leaf roles for a decode cell on a fake group of
    256 ranks (its batch over `data`, its caches by ``cache_specs``)."""
    plan, _, _ = DR.plan_cell(arch, shape, multi_pod=False)
    B = SHAPES[shape].global_batch
    with DR.fake_world(256, "cpu"):
        mesh = make_production_mesh(device="cpu")
        roles, _ = SD.plan_layout(ARCHS[arch], plan.param_specs(), mesh,
                                  SH.P("data", None), plan.cache_specs(B))
    return roles


def _gathered_bytes(arch, shape) -> int:
    """What a decode step gathers, from the plan's specs alone: each param
    leaf once, whole (full - local bytes) where its blocks run it whole,
    over every dim but `model` where a tensor-parallel block keeps its
    `model` shard; each cache leaf once around its block, or around its
    attention in a tensor-parallel block (time over `model`), over every
    dim but the batch's (full / batch shards - local); and in each
    tensor-parallel attention the new row of the KV heads the other
    `model` ranks own (``sharded._fill_heads``)."""
    plan, _, _ = DR.plan_cell(arch, shape, multi_pod=False)
    roles = _roles(arch, shape)
    total = 0
    params = C.abstract_params(ARCHS[arch])
    for name, x, spec in zip(tree.names(params), tree.leaves(params),
                             SH.spec_leaves(plan.param_specs())):
        full = x.numel() * x.element_size()
        keep = (_axes_size("model") if roles.get(name) == "local"
                else 1)
        total += full // keep - full // _shards(spec)
    B = SHAPES[shape].global_batch
    cache = T.init_cache(ARCHS[arch], B, SHAPES[shape].seq_len,
                         device="meta")
    for x, spec in zip(tree.leaves(cache),
                       SH.spec_leaves(plan.cache_specs(B))):
        full = x.numel() * x.element_size()
        rows = _axes_size(spec[1]) if len(spec) > 1 else 1
        total += full // rows - full // _shards(spec)
    arch = ARCHS[arch]
    m = _axes_size("model")
    tp_attn = {n.rsplit(".attn.", 1)[0] for n, r in roles.items()
               if ".attn.wq." in n and r == "local"}
    heads = (arch.n_kv_heads // m if arch.n_kv_heads % m == 0 else
             len(L.local_groups(arch.n_heads, arch.n_kv_heads, m, 0)))
    reps = {f"segments.{si}.b{bi}": seg.repeat
            for si, seg in enumerate(arch.pattern)
            for bi in range(len(seg.blocks))}
    total += sum(2 * reps[b] for b in tp_attn) * (m - 1) * (
        B // _axes_size("data")) * heads * arch.resolved_head_dim * 2
    return total


def test_decode_cell_runs_on_a_fake_group_of_256():
    """``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
    decode_32k --no-save --device cpu`` in a subprocess: exit 0, status
    ok, memory / cost / collectives printed, no production-size
    allocation (the child's peak RSS), its all-gather bytes equal to the
    count from the plan's specs (the tensor-parallel blocks keep their
    weights' `model` shards), its all-reduces the row-parallel
    projections', nothing else collected."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "decode_32k", "--no-save", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for key in ("memory: ", "cost: ", "collectives: "):
        assert any(l.startswith(key) for l in lines), key
    rec = json.loads(next(l for l in lines if l.startswith("record "))[7:])
    assert rec["status"] == "ok"
    assert resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024 \
        < MAX_RSS_BYTES
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and \
        mem["temp_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and \
        rec["cost"]["kernel_calls"]["rmsnorm"] == 4 * 36 + 1
    coll = rec["collectives"]
    assert coll["all-gather"]["bytes"] == _gathered_bytes("qwen3-8b",
                                                         "decode_32k")
    assert coll["all-gather"]["count"] > 0
    # two row-parallel all-reduces a layer (wo, w_out) of this rank's
    # 8 rows of one token, bf16
    arch = ARCHS["qwen3-8b"]
    assert coll["all-reduce"] == {"count": 2 * 36,
                                  "bytes": 2 * 36 * 8 * arch.d_model * 2,
                                  "result_bytes": 2 * 36 * 8 *
                                  arch.d_model * 2}
    for kind in ("reduce-scatter", "all-to-all"):
        assert coll[kind]["count"] == 0, kind
    assert rec["model_flops"] == DR.model_flops("qwen3-8b", "decode_32k")
    # chip_smoke.py phase 45 holds the card's count to this record
    assert rec["cost"] == smoke_cost()[("qwen3-8b", "decode_32k")]


def _reference_ep_plan(arch, shape, multi_pod):
    """The reference's ``build_cell`` planning of a ``--moe-ep`` cell:
    ``AdaptiveScheduler(moe_ep=True)`` at the dry run's settings."""
    ja, js = J_ARCHS[arch], J_SHAPES[shape]
    preset = "adamw8bit" if arch in DR.QUANTIZED_OPT else "adamw32"
    return JScheduler(faithful=False, opt_preset=preset, remat="full",
                      seq_sharded=False, moe_ep=True).plan(
        ja, js, JMesh(16, 16, pod=2 if multi_pod else 1))


@pytest.mark.parametrize("arch,shape,multi_pod",
                         [("deepseek-v3-671b", "decode_32k", False),
                          ("arctic-480b", "train_4k", True)])
def test_moe_ep_plan_matches_reference(arch, shape, multi_pod):
    """``plan_cell(..., moe_ep=True)`` on a MoE arch: the reference's
    ``AdaptiveScheduler(moe_ep=True)`` plan, exactly (assignment, method,
    predicted cost, microbatches), and under ``moe_ep_axis`` the
    reference's specs with its ``MOE_EP_AXIS = "data"``, every expert
    stack EP-major."""
    from repro.core import sharding as JSH
    plan, meta, _ = DR.plan_cell(arch, shape, multi_pod=multi_pod,
                                 moe_ep=True)
    want = _reference_ep_plan(arch, shape, multi_pod)
    assert meta["assignment"] == {k: str(v) for k, v in
                                  want.assignment.items()}
    assert (meta["method"], meta["feasible"], meta["predicted"],
            meta["microbatches"]) == (want.plan.method, want.plan.feasible,
                                      want.plan.cost, want.microbatches)
    with DR.moe_ep_axis(ARCHS[arch], True):
        got = SH.spec_leaves(plan.param_specs())
    assert SH.MOE_EP_AXIS == "model"
    saved = JSH.MOE_EP_AXIS
    JSH.MOE_EP_AXIS = "data"
    try:
        import jax
        ref = [tuple(s) for s in jax.tree.leaves(
            want.param_specs(), is_leaf=lambda x: hasattr(x, "_partitions")
            or type(x).__name__ == "PartitionSpec")]
    finally:
        JSH.MOE_EP_AXIS = saved
    assert [tuple(s) for s in got] == ref
    names = tree.names(C.abstract_params(ARCHS[arch]))
    stacks = [tuple(s) for n, s in zip(names, got) if ".moe.w_" in n]
    assert stacks and all(s in ((None, "data", None, "model"),
                                (None, "data", "model", None))
                          for s in stacks), set(stacks)


def test_moe_ep_leaves_a_dense_arch_unchanged():
    """``--moe-ep`` on a dense arch: the same plan, meta and specs as
    without it (the reference sets the EP-major layout on MoE archs
    only)."""
    a, meta_a, _ = DR.plan_cell("qwen3-8b", "decode_32k", multi_pod=False,
                                moe_ep=True)
    b, meta_b, _ = DR.plan_cell("qwen3-8b", "decode_32k", multi_pod=False)
    assert meta_a == meta_b
    with DR.moe_ep_axis(ARCHS["qwen3-8b"], True):
        specs = a.param_specs()
    assert specs == b.param_specs()


# deepseek-v3-671b at published widths, one layer of each segment (an
# mla_dense and an mla layer with all 256 experts), so that the cell
# traces in seconds
_EP_CELL = """
import dataclasses, json, sys
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as DR
arch = get_arch("deepseek-v3-671b")
cut = dataclasses.replace(arch, n_layers=len(arch.pattern), pattern=tuple(
    dataclasses.replace(s, repeat=1) for s in arch.pattern))
rec = DR.run_cell(cut, "decode_32k", moe_ep=True, save=False, device="cpu")
print("record " + json.dumps(rec, default=str))
"""


def test_moe_ep_cell_records_the_specs_all_to_alls():
    """A ``--moe-ep`` decode cell (``run_cell(..., moe_ep=True)``) of
    deepseek-v3-671b cut to one mla_dense and one mla layer, in a
    subprocess on a fake group of 256: status ok, the expert stacks
    never gathered, and two all-to-alls for its one MoE layer (dispatch
    and return), each of E * B_l * C * D bf16 values (C = 1 at one token a
    row, B_l = 128 / 16 rows a rank)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _EP_CELL],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(next(l for l in out.stdout.splitlines()
                          if l.startswith("record "))[7:])
    assert rec["status"] == "ok", rec.get("traceback")
    arch = ARCHS["deepseek-v3-671b"]
    E, D = arch.moe.n_experts, arch.d_model
    B_l = SHAPES["decode_32k"].global_batch // 16
    C = max(1, int(arch.moe.capacity_factor * arch.moe.top_k / E))
    one = E * B_l * C * D * 2
    coll = rec["collectives"]
    assert coll["all-to-all"] == {"count": 2, "bytes": 2 * one,
                                  "result_bytes": 2 * one}
    # one layer's expert stacks, 3 x 256 x 7168 x 2048 bf16, are never
    # gathered: everything gathered is far less
    assert coll["all-gather"]["result_bytes"] < \
        3 * E * D * arch.moe.d_ff * 2 / 4
    assert rec["assignment"]["seg1/b0:mla.ffn"] in ("MP", "HP")


def test_train_kernels_count_forward_and_backward_by_formula():
    """Under grad the dry run's recorder counts each kernel call and its
    backward kernel by their formulas (``ircost.kernel_work`` /
    ``kernel_bwd_work``), runs no plain version (no op but the test's
    own), and hands autograd gradients of the inputs' shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import ircost as IC
    from repro_torch.kernels import ops as kops
    with FakeTensorMode():
        x = torch.empty(8, 64, dtype=torch.bfloat16, requires_grad=True)
        sc = torch.empty(64, requires_grad=True)
        q = torch.empty(2, 16, 4, 32, requires_grad=True)
        k = torch.empty(2, 16, 2, 32, requires_grad=True)
        xs = torch.empty(1, 32, 4, 8, requires_grad=True)
        bm = torch.empty(1, 32, 1, 16, requires_grad=True)
        dt = torch.empty(1, 32, 4, requires_grad=True)
        a = torch.empty(1, 32, 4, requires_grad=True)
        calls = [("rmsnorm", (x, sc, 1e-6), {}),
                 ("flash_attention", (q, k, k), {"causal": True}),
                 ("ssd_scan", (xs, bm, bm, dt, a, None), {"chunk": 16})]
        r = DR._Recorder()
        with kops.kernel_hook(r.kernel), r:
            y = kops.rmsnorm(x, sc)
            o = kops.flash_attention(q, k, k)
            ys, _ = kops.ssd_scan(xs, bm, bm, dt, a, None, chunk=16)
            before = r.flops
            loss = y.float().sum() + o.sum() + ys.sum()
            loss.backward()
        fwd = [IC.kernel_work(n, ar, kw) for n, ar, kw in calls]
        bwd = [IC.kernel_bwd_work(n, ar, kw, False) for n, ar, kw in calls]
        assert dict(r.kernel_calls) == {
            "rmsnorm": 1, "flash_attention": 1, "ssd_scan": 1,
            "rmsnorm_bwd": 1, "flash_attention_bwd": 1, "ssd_scan_bwd": 1}
        # the test's own ops (sum, add, casts) have no FLOPs
        assert before == sum(sum(f.values()) for _, f in fwd)
        assert r.flops == before + sum(sum(f.values()) for _, f in bwd)
        for (n, _, _), (nb, _), (bb, _) in zip(calls, fwd, bwd):
            assert r.by_op[f"kernel::{n}"] == nb
            assert r.by_op[f"kernel::{n}_bwd"] == bb > 0
        plain = {op for op in r.ops if not op.startswith("kernel::")}
        assert plain <= {"aten.sum", "aten.add", "aten._to_copy",
                         "aten.ones_like", "aten.expand"}, plain
        for t in (x, sc, q, k, xs, bm, dt, a):
            assert t.grad is not None and t.grad.shape == t.shape

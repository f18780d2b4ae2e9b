"""The PyTorch port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro/launch/dryrun.py``, on the CPU: model FLOPs and shape
applicability for every cell, the plan meta of three cells, one cell run
end to end on a fake group of 256 ranks in a subprocess (its all-gather
bytes against a count made from the plan's specs), and ``--moe-ep``
refused on a MoE arch by name.  Exact equality throughout: planning is
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
from repro_torch.models import transformer as T

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


def _gathered_bytes(arch, shape) -> int:
    """What a decode step gathers, from the plan's specs alone: each param
    leaf once (whole: full - local bytes), each cache leaf once around its
    block over every dim but the batch's (full / batch shards - local)."""
    plan, _, _ = DR.plan_cell(arch, shape, multi_pod=False)
    total = 0
    params = C.abstract_params(ARCHS[arch])
    for x, spec in zip(tree.leaves(params),
                       SH.spec_leaves(plan.param_specs())):
        full = x.numel() * x.element_size()
        total += full - full // _shards(spec)
    B = SHAPES[shape].global_batch
    cache = T.init_cache(ARCHS[arch], B, SHAPES[shape].seq_len,
                         device="meta")
    for x, spec in zip(tree.leaves(cache),
                       SH.spec_leaves(plan.cache_specs(B))):
        full = x.numel() * x.element_size()
        rows = _axes_size(spec[1]) if len(spec) > 1 else 1
        total += full // rows - full // _shards(spec)
    return total


def test_decode_cell_runs_on_a_fake_group_of_256():
    """``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
    decode_32k --no-save --device cpu`` in a subprocess: exit 0, status
    ok, memory / cost / collectives printed, no production-size
    allocation (the child's peak RSS), and its all-gather bytes equal to
    the count from the plan's specs, nothing else collected."""
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
    for kind in ("reduce-scatter", "all-reduce", "all-to-all"):
        assert coll[kind]["count"] == 0, kind
    assert rec["model_flops"] == DR.model_flops("qwen3-8b", "decode_32k")
    # chip_smoke.py phase 45 holds the card's count to this record
    assert rec["cost"] == smoke_cost()[("qwen3-8b", "decode_32k")]


def test_moe_ep_is_refused_by_name(capsys):
    """``--moe-ep`` on a MoE arch: the CLI refuses before any cell runs,
    naming the arch and the missing all-to-all; ``plan_cell`` raises."""
    with pytest.raises(SystemExit) as e:
        DR.main(["--arch", "deepseek-v3-671b", "--shape", "decode_32k",
                 "--moe-ep", "--no-save", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "deepseek-v3-671b" in err and "all-to-all" in err
    with pytest.raises(NotImplementedError, match="arctic-480b.*all-to-all"):
        DR.plan_cell("arctic-480b", "train_4k", multi_pod=False,
                     moe_ep=True)
    # a dense arch takes the flag: there is no MoE layer to lay out
    DR.plan_cell("qwen3-8b", "decode_32k", multi_pod=False, moe_ep=True)


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

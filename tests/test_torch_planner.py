"""The port's planner (``repro_torch.core``) against the reference's
(``repro.core``), on the CPU: pure host code, so everything is held
exactly (floats with ``==``).

(a) param counts (the port's ``init_lm`` on the meta device against
``jax.eval_shape``), components field by field, ``plan()`` and
``baselines()`` — assignment, method, microbatches, every cost float,
feasibility — and the reference's own solver and cost-model tests,
re-pointed at the port; (b) the spec trees leaf by leaf: ``param_specs``,
``opt_state_specs`` (fp32 and int8 moments), ``cache_specs`` and
``paged_cache_specs`` for the ten configs under the four strategies on
(16, 16) and (2, 16, 16); and how a spec maps onto a DeviceMesh's
placements.
"""
import dataclasses
import types

import jax
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import asa as JA
from repro.core import components as JC
from repro.core import hardware as JHW
from repro.core import sharding as JSH
from repro.core.costmodel import MeshShape as JMeshShape
from repro.core.strategy import Strategy as JStrategy
from repro.optim import optimizers as JO
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, shape_applicable
from repro_torch.core import asa as A
from repro_torch.core import components as C
from repro_torch.core import hardware as HW
from repro_torch.core import sharding as SH
from repro_torch.core.costmodel import MeshShape
from repro_torch.core.strategy import Strategy, UNIFORM_STRATEGIES
from repro_torch.optim import optimizers as O
from torch_port_fixtures import port_arch

NAMES = sorted(ARCHS)
MESHES = [(1, 1, 1), (16, 16, 1), (16, 16, 2)]      # (data, model, pod)
HWS = {"tpu_v5e": (JHW.TPU_V5E, HW.TPU_V5E),
       "v100": (JHW.V100_CLUSTER, HW.V100_CLUSTER),
       # the port's H100 profile given to the reference's planner
       "h100": (JHW.HardwareProfile(**dataclasses.asdict(HW.H100_SXM)),
                HW.H100_SXM)}


def _meshes(d, m, p):
    return JMeshShape(d, m, pod=p), MeshShape(d, m, pod=p)


def test_configs_are_the_references_and_shapes_copied():
    assert sorted(JARCHS) == NAMES
    for n in NAMES:
        assert port_arch(JARCHS[n]) == ARCHS[n]
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    from repro.configs.base import shape_applicable as j_applicable
    for n in NAMES:
        for s in SHAPES:
            assert shape_applicable(ARCHS[n], SHAPES[s]) == \
                j_applicable(JARCHS[n], JSHAPES[s])


def test_h100_profile_constants():
    h = HW.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert (h.link_bw, h.dcn_bw, h.matmul_efficiency) == (450e9, 50e9, 0.6)
    assert not hasattr(JHW, "H100_SXM")


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_exact(name):
    assert C.param_count(ARCHS[name]) == JC.param_count(JARCHS[name])
    assert C.active_param_count(ARCHS[name]) == \
        JC.active_param_count(JARCHS[name])
    # every leaf's shape too, in the reference's flattening order
    port = [tuple(x.shape) for x in SH.tree.leaves(C.abstract_params(
        ARCHS[name]))]
    ref = [tuple(x.shape) for x in jax.tree.leaves(
        JC.abstract_params(JARCHS[name]))]
    assert port == ref
    assert all(x.device.type == "meta"
               for x in SH.tree.leaves(C.abstract_params(ARCHS[name])))


@pytest.mark.parametrize("name", NAMES)
def test_components_equal_field_by_field(name):
    for s in SHAPES:
        if not shape_applicable(ARCHS[name], SHAPES[s])[0]:
            continue
        got = [dataclasses.asdict(c) for c in
               C.components_for_shape(ARCHS[name], SHAPES[s])]
        want = [dataclasses.asdict(c) for c in
                JC.components_for_shape(JARCHS[name], JSHAPES[s])]
        assert got == want, (name, s)
    # the serving-step view (attn_span, moe capacity) as well
    kw = dict(seq_len=64, batch=4, mode="decode", attn_span=256,
              moe_capacity=True)
    assert [dataclasses.asdict(c) for c in
            C.build_components(ARCHS[name], **kw)] == \
        [dataclasses.asdict(c) for c in
         JC.build_components(JARCHS[name], **kw)]


def _plan_view(sp):
    return (sp.plan.method, sp.plan.feasible, sp.microbatches,
            {k: str(v) for k, v in sp.assignment.items()},
            sp.plan.cost, [dataclasses.asdict(c) for c in sp.comps])


def _baseline_view(b):
    return {k: (p.method, p.feasible, p.cost,
                {n: str(s) for n, s in p.assignment.items()})
            for k, p in b.items()}


# each config plans one shape kind (rotating) on every mesh, under every
# hardware profile and both cost-model modes; the train case also with a
# global batch a mesh does not divide (FS not allowed) and the 8-bit preset
KINDS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.mark.parametrize("name", NAMES)
def test_plans_and_baselines_equal(name):
    kind = KINDS[NAMES.index(name) % 3]
    arch, jarch = ARCHS[name], JARCHS[name]
    for hw in HWS:
        jhw, phw = HWS[hw]
        for faithful in (True, False):
            js = JA.AdaptiveScheduler(jhw, faithful=faithful)
            ps = A.AdaptiveScheduler(phw, faithful=faithful)
            for d, m, p in MESHES:
                jm, pm = _meshes(d, m, p)
                got = ps.plan(arch, SHAPES[kind], pm)
                want = js.plan(jarch, JSHAPES[kind], jm)
                assert _plan_view(got) == _plan_view(want), \
                    (name, kind, hw, faithful, (d, m, p))
                assert _baseline_view(ps.baselines(arch, SHAPES[kind], pm)) \
                    == _baseline_view(js.baselines(jarch, JSHAPES[kind], jm))
    # an odd batch (FS refused, microbatch escalation), 8-bit moments,
    # sequence sharding and EP-major MoE; then calibration and replan
    kw = dict(faithful=False, opt_preset="adamw8bit", seq_sharded=True,
              moe_ep=True)
    js, ps = JA.AdaptiveScheduler(**kw), A.AdaptiveScheduler(**kw)
    jm, pm = _meshes(16, 16, 1)
    shp, jshp = ShapeSpec("odd", 2048, 24, "train"), \
        JShapeSpec("odd", 2048, 24, "train")
    a, b = ps.plan(arch, shp, pm), js.plan(jarch, jshp, jm)
    assert _plan_view(a) == _plan_view(b)
    measured = {c.name: (3.0 if "mixer" in c.name else 0.5)
                for c in a.comps}
    predicted = {c.name: 1.0 for c in a.comps}
    ps.calibrate(measured, predicted)
    js.calibrate(measured, predicted)
    assert ps._calibration == js._calibration
    assert _plan_view(ps.replan(arch, shp, pm)) == \
        _plan_view(js.replan(jarch, jshp, jm))


def test_whole_qwen_does_not_fit_one_h100():
    """The chip phase's premise: qwen3-8b's training state (~18 bytes a
    param at bf16 params, fp32 grads and AdamW) does not fit one card."""
    sched = A.AdaptiveScheduler(HW.H100_SXM, faithful=False)
    sp = sched.plan(ARCHS["qwen3-8b"], ShapeSpec("chip", 512, 2, "train"),
                    MeshShape(1, 1))
    assert not sp.plan.feasible
    assert sp.plan.cost["mem_per_device"] > 130e9


def test_summary_says_where_compute_is_tensor_parallel():
    sched = A.AdaptiveScheduler()
    sp = sched.plan(ARCHS["qwen3-8b"], SHAPES["train_4k"], MeshShape(16, 16))
    jsp = JA.AdaptiveScheduler().plan(JARCHS["qwen3-8b"], JSHAPES["train_4k"],
                                     JMeshShape(16, 16))
    got, want = sp.summary().splitlines(), jsp.summary().splitlines()
    assert got[:len(want)] == want
    if any(str(s) in ("MP", "HP") for s in sp.assignment.values()):
        assert "tensor-parallel over `model` in dense attn blocks only" \
            in got[-1]


# ---------------------------------------------------------------------------
# (b) specs, leaf by leaf
# ---------------------------------------------------------------------------

def _jspec_leaves(t):
    return [None if x is None else tuple(x) for x in jax.tree.leaves(
        t, is_leaf=lambda x: x is None or isinstance(
            x, jax.sharding.PartitionSpec))]


def _assignment(comps, s):
    return {c.name: s for c in comps}


@pytest.mark.parametrize("name", NAMES)
def test_param_and_cache_specs_equal(name):
    arch, jarch = ARCHS[name], JARCHS[name]
    comps = C.components_for_shape(arch, SHAPES["train_4k"])
    for s in UNIFORM_STRATEGIES:
        asg = _assignment(comps, s)
        jasg = {k: JStrategy(str(v)) for k, v in asg.items()}
        for d, m, p in MESHES[1:]:
            jm, pm = _meshes(d, m, p)
            got = SH.param_specs(arch, asg, pm)
            want = JSH.param_specs(jarch, jasg, jm)
            assert [tuple(x) for x in SH.spec_leaves(got)] == \
                _jspec_leaves(want), (name, s, (d, m, p))
            assert [None if x is None else tuple(x) for x in
                    SH.spec_leaves(SH.cache_specs(arch, asg, pm, 128))] == \
                _jspec_leaves(JSH.cache_specs(jarch, jasg, jm, 128))
            assert [tuple(x) for x in SH.spec_leaves(
                SH.paged_cache_specs(arch, asg, pm))] == \
                _jspec_leaves(JSH.paged_cache_specs(jarch, jasg, jm))


@pytest.mark.parametrize("name", NAMES)
def test_opt_state_specs_equal_fp32_and_int8(name):
    arch, jarch = ARCHS[name], JARCHS[name]
    comps = C.components_for_shape(arch, SHAPES["train_4k"])
    aparams = C.abstract_params(arch)
    japarams = JC.abstract_params(jarch)
    for quantized in (False, True):
        ostate = O.adamw(1e-3, quantized=quantized)[0](aparams)
        jostate = jax.eval_shape(JO.adamw(1e-3, quantized=quantized)[0],
                                 japarams)
        for s in UNIFORM_STRATEGIES:
            asg = _assignment(comps, s)
            jasg = {k: JStrategy(str(v)) for k, v in asg.items()}
            for d, m, p in MESHES[1:]:
                jm, pm = _meshes(d, m, p)
                got = SH.opt_state_specs(ostate, SH.param_specs(arch, asg, pm),
                                         pm)
                want = JSH.opt_state_specs(
                    jostate, JSH.param_specs(jarch, jasg, jm), jm)
                flat = []
                for part in (got.step, got.mu, got.nu):
                    for x in SH.spec_leaves(part):
                        flat += [tuple(x.q), tuple(x.scale)] \
                            if hasattr(x, "signed") else [tuple(x)]
                assert flat == _jspec_leaves(
                    (want.step, want.mu, want.nu)), (name, quantized, s)
                assert got.extra is None and want.extra is None


def test_placements_follow_the_mesh_order():
    """Each spec places on the mesh in the reference's block order: plain
    ``Shard``s where the spec lists a dim's axes in the mesh's order, a
    ``_StridedShard`` on the mesh dim that the spec makes minor but the
    mesh lays out first (HP's ``("data", "pod")``, the int8 moments'
    ``("data", "model", "pod")``).  Only a spec that no placement can
    lay out is refused: an axis the mesh lacks, or one mesh axis for two
    dims (a mesh dim splits one tensor dim)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh2 = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(16, 16))
    mesh3 = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                  shape=(2, 16, 16))
    R = Replicate()
    assert SH.placements(SH.P(None, "model"), mesh2) == (R, Shard(1))
    assert SH.placements(SH.P("data", "model"), mesh2) == (Shard(0), Shard(1))
    assert SH.placements(SH.P(("data", "model")), mesh2) == \
        (Shard(0), Shard(0))
    assert SH.placements(SH.P(), mesh2) == (R, R)
    assert SH.placements(SH.P(("pod", "data"), None), mesh3) == \
        (Shard(0), Shard(0), R)
    # the reference's multi-pod HP ZeRO dim lists data before pod: pod's
    # shards stride over data's 16 (rank (p, d) holds block 2 d + p)
    hp = SH.placements(SH.P(("data", "pod"), "model"), mesh3)
    assert isinstance(hp[0], _StridedShard)
    assert (hp[0].dim, hp[0].split_factor) == (0, 16)
    assert hp[1:] == (Shard(0), Shard(1))
    # the int8 moments' flat dim: pod strides over data x model
    q = SH.placements(SH.P(("data", "model", "pod"), None), mesh3)
    assert isinstance(q[0], _StridedShard)
    assert (q[0].dim, q[0].split_factor) == (0, 256)
    assert q[1:] == (Shard(0), Shard(0))
    # a pod axis of one rank orders nothing
    one_pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                    shape=(1, 16, 16))
    assert SH.placements(SH.P(("data", "pod"), "model"), one_pod) == \
        (Shard(0), Shard(0), Shard(1))
    # what no placement lays out is refused, naming the spec
    with pytest.raises(ValueError, match="lacks"):
        SH.placements(SH.P("pod"), mesh2)
    with pytest.raises(ValueError, match=r"P\('data', 'data'\).*one dim"):
        SH.placements(SH.P("data", "data"), mesh2)
    # and the specs that need a stride on a (2, 16, 16) mesh are exactly
    # HP's and FS's ZeRO dims, each placed with pod strided over data
    arch = ARCHS["qwen3-8b"]
    comps = C.components_for_shape(arch, SHAPES["train_4k"])
    for s in UNIFORM_STRATEGIES:
        specs = SH.spec_leaves(SH.param_specs(
            arch, _assignment(comps, s), MeshShape(16, 16, pod=2)))
        bad = [x for x in specs if ("data", "pod") in tuple(x)]
        assert bool(bad) == (s in (Strategy.HP, Strategy.FS)), s
        for x in bad:
            pl = SH.placements(x, mesh3)[0]
            assert isinstance(pl, _StridedShard) and pl.split_factor == 16


def test_batch_slice_takes_rows_in_the_references_order():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 3, 2)

        def __init__(self, coords):
            self.coords = coords

        def get_local_rank(self, mesh_dim):
            return self.coords[mesh_dim]
    rows = []
    for pod in range(2):
        for data in range(3):
            sl = SH.batch_slice(SH.NamedSharding(
                Mesh((pod, data, 1)), SH.P(("pod", "data"), None)), 12)
            rows.append((sl.start, sl.stop))
    assert rows == [(2 * i, 2 * i + 2) for i in range(6)]
    sl = SH.batch_slice(SH.NamedSharding(Mesh((1, 2, 1)), SH.P(None)), 12)
    assert (sl.start, sl.stop) == (0, 12)
    with pytest.raises(ValueError, match="does not split"):
        SH.batch_slice(SH.NamedSharding(Mesh((0, 0, 0)),
                                        SH.P(("data", "model"))), 5)


# ---------------------------------------------------------------------------
# the reference's solver and cost-model tests (tests/test_solver.py,
# tests/test_costmodel.py), re-pointed at the port
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from repro_torch.core.components import Component  # noqa: E402
from repro_torch.core.costmodel import CostModel  # noqa: E402
from repro_torch.core.hardware import (TPU_V5E, allgather_time,  # noqa: E402
                                       alltoall_time, reducescatter_time,
                                       ring_allreduce_time)
from repro_torch.core.solver import (solve, solve_exhaustive,  # noqa: E402
                                     solve_greedy, solve_uniform)
from repro_torch.core.strategy import ALL_STRATEGIES  # noqa: E402

@st.composite
def component_lists(draw, max_comps=6):
    n = draw(st.integers(2, max_comps))
    comps = []
    for i in range(n):
        params = draw(st.floats(1e6, 5e10))
        flops = draw(st.floats(1e9, 1e15))
        act = draw(st.floats(1e5, 1e9))
        comps.append(Component(
            name=f"c{i}", kind="attn", count=draw(st.integers(1, 8)),
            params=params, shared_params=False, flops_fwd=flops,
            act_bytes=act, n_model_allreduce=draw(st.integers(1, 3)),
            moe_a2a_bytes=0.0, kv_bytes=act))
    return comps


def _solver_cm(mode="train", faithful=True):
    return CostModel(hw=TPU_V5E, mesh=MeshShape(16, 16), mode=mode,
                     faithful=faithful)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(component_lists())
def test_adaptive_never_loses_to_static(comps):
    """cost(ASA) <= cost(best feasible uniform) — the paper's headline."""
    cm = _solver_cm()
    plan = solve(cm, comps)
    for s in ALL_STRATEGIES:
        u = solve_uniform(cm, comps, s)
        if u.cost["mem_per_device"] <= cm.hw.hbm_bytes and plan.feasible:
            assert plan.cost["time"] <= u.cost["time"] * (1 + 1e-9)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(component_lists())
def test_solver_respects_memory_when_possible(comps):
    cm = _solver_cm()
    limit = cm.hw.hbm_bytes
    any_feasible = any(
        cm.assignment_cost(comps, {c.name: s for c in comps})["mem_per_device"]
        <= limit for s in ALL_STRATEGIES)
    plan = solve(cm, comps, mem_limit=limit)
    if any_feasible:
        assert plan.feasible
        assert plan.cost["mem_per_device"] <= limit * (1 + 1e-9)


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(component_lists(max_comps=5))
def test_greedy_matches_exhaustive_when_unconstrained(comps):
    """With no memory pressure, greedy == exhaustive == per-comp argmin."""
    cm = _solver_cm()
    g = solve_greedy(cm, comps, mem_limit=float("inf"))
    e = solve_exhaustive(cm, comps, mem_limit=float("inf"))
    assert abs(g.cost["time"] - e.cost["time"]) <= 1e-9 * e.cost["time"] + 1e-12


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(component_lists(max_comps=4))
def test_greedy_within_bound_of_exhaustive(comps):
    cm = _solver_cm()
    g = solve_greedy(cm, comps)
    e = solve_exhaustive(cm, comps)
    if g.feasible and e.feasible:
        assert g.cost["time"] <= 2.0 * e.cost["time"] + 1e-12


def test_memory_ordering():
    """Per-component memory: DP >= MP >= HP (the repair direction)."""
    c = Component("c", "attn", 4, params=1e9, shared_params=False,
                  flops_fwd=1e12, act_bytes=1e8, n_model_allreduce=2)
    cm = _solver_cm()
    mems = {s: (cm.component_cost(c, s).mem_params
                + cm.component_cost(c, s).mem_act) for s in ALL_STRATEGIES}
    assert mems[Strategy.DP] >= mems[Strategy.MP] >= mems[Strategy.HP]


def test_faithful_mode_has_no_transition_costs():
    cm = _solver_cm(faithful=True)
    assert cm.transition_cost(Strategy.DP, Strategy.MP, 1e9) == 0.0
    cm2 = _solver_cm(faithful=False)
    assert cm2.transition_cost(Strategy.DP, Strategy.MP, 1e9) > 0.0
    assert cm2.transition_cost(Strategy.MP, Strategy.MP, 1e9) == 0.0


def _comp(params=1e9, flops=1e13, act=1e8, count=4, a2a=0.0):
    return Component("c", "attn", count, params=params, shared_params=False,
                     flops_fwd=flops, act_bytes=act, n_model_allreduce=2,
                     moe_a2a_bytes=a2a, kv_bytes=act)


def _cm(**kw):
    base = dict(hw=TPU_V5E, mesh=MeshShape(16, 16), mode="train",
                faithful=False)
    base.update(kw)
    return CostModel(**base)


def test_collective_time_formulas():
    assert ring_allreduce_time(1e9, 1, 50e9) == 0.0
    assert abs(ring_allreduce_time(1e9, 16, 50e9)
               - 2 * 15 / 16 * 1e9 / 50e9) < 1e-12
    assert allgather_time(1e9, 16, 50e9) < ring_allreduce_time(1e9, 16, 50e9)
    assert reducescatter_time(1e9, 16, 50e9) == allgather_time(1e9, 16, 50e9)
    assert alltoall_time(0, 16, 50e9) == 0.0


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(st.floats(1e6, 1e11), st.floats(1e10, 1e16))
def test_more_microbatches_never_increase_act_memory(params, flops):
    c = _comp(params=params, flops=flops)
    m1 = _cm(microbatches=1).component_cost(c, Strategy.HP)
    m8 = _cm(microbatches=8).component_cost(c, Strategy.HP)
    assert m8.mem_act <= m1.mem_act + 1e-9
    # ...but they do increase ZeRO gather traffic
    assert m8.t_comm >= m1.t_comm - 1e-12


def test_seq_sharding_halves_mp_act_comm():
    c = _comp()
    base = _cm(seq_sharded=False).component_cost(c, Strategy.MP)
    sp = _cm(seq_sharded=True).component_cost(c, Strategy.MP)
    assert sp.t_comm < base.t_comm
    assert sp.mem_act <= base.mem_act


def test_fs_shards_params_over_all_chips():
    c = _comp(params=1e10)
    cm = _cm()
    fs = cm.component_cost(c, Strategy.FS)
    hp = cm.component_cost(c, Strategy.HP)
    # single-pod: FS and HP both shard 256-way
    assert abs(fs.mem_params - hp.mem_params) / hp.mem_params < 1e-6
    cm2 = _cm(mesh=MeshShape(16, 16, pod=2))
    fs2 = cm2.component_cost(c, Strategy.FS)
    assert fs2.mem_params < fs.mem_params  # 512-way now


def test_moe_ep_removes_gather_traffic():
    c = _comp(params=5e10, a2a=1e9)
    base = _cm(moe_ep=False).component_cost(c, Strategy.HP)
    ep = _cm(moe_ep=True).component_cost(c, Strategy.HP)
    assert ep.t_comm < base.t_comm
    assert ep.mem_params <= base.mem_params + 1e-9


def test_decode_mode_has_no_grad_traffic():
    c = _comp()
    dec = _cm(mode="decode").component_cost(c, Strategy.MP)
    tr = _cm(mode="train").component_cost(c, Strategy.MP)
    assert dec.t_comm < tr.t_comm
    assert dec.t_comp < tr.t_comp


def test_faithful_mode_is_pure_paper_model():
    """faithful: no bandwidth floor, no pod grad term, no transitions."""
    c = _comp(params=1e10, flops=1e10)   # tiny flops => bw floor would bind
    f = _cm(faithful=True).component_cost(c, Strategy.MP)
    o = _cm(faithful=False).component_cost(c, Strategy.MP)
    assert o.t_comp >= f.t_comp          # bw floor only in optimized mode

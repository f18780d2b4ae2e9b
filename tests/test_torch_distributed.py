"""The port's sharded training (``repro_torch.runtime.trainer``,
``runtime/sharded.py``, ``checkpoint``, ``launch``) on the CPU.

(c) Four gloo ranks, spawned three times for this module
(``torch_dist_worker.py``: ``run``, ``run_tp``, ``run_moe``): 4 steps of
test_convergence_parity's arch (4 heads over 4) and of tiny-rt (4 over 2:
the KV projections stay replicated on model = 4), and 2 steps (losses and
grad norms) of the tiny mamba2 (one and two B/C groups), zamba2 (shared
block + mamba2), whisper (encoder + wdec, a frontend in each batch) and
llama-vision (attn + gated cross attention, a frontend in each batch)
configs, and of the MoE family's (tiny-mla-ep: latent attention, 8
experts top 2 behind a sigmoid router, a shared expert, the MTP head;
tiny-moe: GQA attention, 8 experts top 2 behind a softmax router, the
dense residual FFN, capacity drops), under uniform DP on (4, 1), MP on
(1, 4), HP on (2, 2), FS on (2, 2) and the ASA's own plan on (2, 2), each
spawn within 120 s, against the single-rank Trainer (a world of 1 in
this process) at test_convergence_parity's tolerances (2e-4 for DP and
FS, 2e-3 where the compute is tensor-parallel); local shards are the
spec's division; under MP each rank's SSD scans run H / 4 heads, its
x_proj and wq work at a quarter of their columns, its latent attentions
at H / 4 heads and its MoE layers at E / 4 experts, and no leaf the
specs shard over `model` is all-gathered over it but the embedding and
head; the MoE family's every step-1 gradient under MP, gathered, equals
the single-rank one (the router's too: the aux loss, computed whole on
every rank, counted once); the all-gather by hand
(for gloo over CUDA tensors) lays shards out as DTensor does; the
split-row RMSNorm over the four ranks equals the reference's whole-row
norm, forward and gradients; a checkpoint saved on (4, 1) restores onto (2, 2) bit for
bit.  The single-rank Trainer equals the mesh-free JAX step on the same
params (and frontends) at 1e-5.  The EP-major MoE layout (experts over
`data`, their FF dim over `model`, an all-to-all dispatch) under HP on
(2, 2) and (4, 1): losses and grad norms at 1e-5, every step-1 gradient
leaf by leaf, each rank's expert stacks its spec's block, the
all-to-alls' count and bytes from the specs, and one forward against
the reference's ``moe`` at 1e-5.  The contiguous prefill and decode
steps through the tensor-parallel blocks under MP on (1, 4), their
caches at the plan's ``cache_specs``: the unplaced steps' logits at
1e-5 and the reference's greedy tokens.

(d) The reference's trainer tests re-pointed at the port (their JAX
originals fail on jax 0.9.0: its ``Trainer.train`` raises): end to end,
restart, exact crash-restart, same-mesh resize (atol 0), straggler
coverage; the ROADMAP anchor; checkpoints interchanged with the
reference's store; a bf16 round trip; int8 AdamW against the reference;
the launcher and the quickstart.
"""
import dataclasses
import pathlib
import pickle
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro.checkpoint import restore_pytree as j_restore
from repro.checkpoint import save_pytree as j_save
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.optim import quantized as JQ
from repro.optim import schedules as JS
from repro.runtime import steps as JST
from repro.runtime.steps import jit_step
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch import convert, tree
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    save_pytree)
from repro_torch.data import HostShardedLoader, SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.optim import optimizers as O
from repro_torch.optim import quantized as Q
from repro_torch.optim import schedules as TS
from repro_torch.runtime.trainer import TrainConfig, Trainer
from torch_port_fixtures import port_arch
from test_torch_train import ANCHOR_LOSSES, TINY_RT

TOL = {"DP": 2e-4, "FS": 2e-4, "MP": 2e-3, "HP": 2e-3, "ASA": 2e-3}
SHAPE = W.SHAPE


@pytest.fixture(scope="module", autouse=True)
def _world_of_one():
    """Tests here start a world of 1 in this process (``make_host_mesh``)
    when they need one; tear it down after the module.  Their tensors are
    tiny, so torch runs them on one thread (several threads a worker
    oversubscribe the cores the parallel test run shares)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    M.shutdown()
    torch.set_num_threads(threads)


def _spawn(fn):
    d = pathlib.Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    mp.start_processes(fn, args=(4, str(d / "store"), str(d / "out.pkl")),
                       nprocs=4, start_method="spawn")
    res = pickle.loads((d / "out.pkl").read_bytes())
    res["seconds"] = time.perf_counter() - t0
    return res


@pytest.fixture(scope="module")
def four_ranks():
    return _spawn(W.run)


@pytest.fixture(scope="module")
def four_ranks_tp():
    """The tensor-parallel kinds' archs on four ranks (``W.run_tp``)."""
    return _spawn(W.run_tp)


@pytest.fixture(scope="module")
def four_ranks_moe():
    """The MoE family's archs on four ranks (``W.run_moe``)."""
    return _spawn(W.run_moe)


def _ranks(request, name):
    """The spawn that trains arch ``name``."""
    return request.getfixturevalue(
        "four_ranks_moe" if name in W.MOE_ARCHS else
        "four_ranks_tp" if name in W.TP_ARCHS else "four_ranks")


def _steps(name):
    return W.TP_STEPS if name in W.TP_ARCHS else W.STEPS


@pytest.fixture(scope="module")
def single_rank():
    """Each arch's losses on a world of 1 (fp32 and int8 moments), and
    for the tensor-parallel kinds' archs their grad norms."""
    out = {}
    for name, arch in W.ARCHS.items():
        mesh = M.make_host_mesh(device="cpu")
        tr, p, o, losses = W.train(arch, mesh, "DP", steps=_steps(name))
        out[name] = losses
        out[name, "grad_norms"] = tr.grad_norms
    out["tiny-rt-int8"] = W.train(W.ARCHS["tiny-rt"],
                                  M.make_host_mesh(device="cpu"), "HP",
                                  quantized=True, steps=3)[3]
    return out


@pytest.mark.parametrize("name", sorted(W.ARCHS))
@pytest.mark.parametrize("case", [c[0] for c in W.CASES])
def test_four_ranks_train_like_one(request, single_rank, name, case):
    ranks = _ranks(request, name)
    got = ranks["losses"][(name, case)]
    np.testing.assert_allclose(got, single_rank[name], rtol=TOL[case],
                               atol=TOL[case])
    if name in W.TP_ARCHS:      # 2 steps: their grad norms too
        np.testing.assert_allclose(ranks["grad_norms"][(name, case)],
                                   single_rank[name, "grad_norms"],
                                   rtol=TOL[case], atol=TOL[case])
    assert ranks["shards"][(name, case)] == []
    full, local = ranks["sharded"][(name, case)]
    # storage really is sharded: wq holds 1/(data*model) a rank under HP
    # and FS, 1/model under MP, all of it under DP
    div = {"DP": 1, "MP": 4, "HP": 4, "FS": 4}.get(case)
    if div is not None:
        assert np.prod(local) * div == np.prod(full), (case, full, local)


def test_asa_plan_on_four_ranks_is_the_planners(four_ranks):
    assert four_ranks["methods"][("tiny-rt", "ASA")] == \
        W.scheduler(None).plan(W.ARCHS["tiny-rt"], SHAPE,
                               M.MeshShape(2, 2)).plan.method
    assert four_ranks["seconds"] < 120


def test_tp_kinds_spawn_is_as_cheap(four_ranks_tp):
    assert four_ranks_tp["seconds"] < 120


def test_moe_spawn_is_as_cheap(four_ranks_moe):
    assert four_ranks_moe["seconds"] < 120


def test_int8_moments_on_four_ranks(four_ranks, single_rank):
    np.testing.assert_allclose(four_ranks["losses"][("tiny-rt", "HP-int8")],
                               single_rank["tiny-rt-int8"], rtol=2e-3,
                               atol=2e-3)


def test_checkpoint_reshards_from_4x1_to_2x2(four_ranks):
    r = four_ranks["reshard"]
    assert r["step"] == 2
    assert r["params_equal"] and r["mu_equal"]
    # embedding (512... no: vocab 256 padded to 256) x 64 under HP on
    # (2, 2): P("model", "data") -> a quarter on each rank
    assert r["local_shapes"][0] == (128, 32)


def _jax_losses(arch, params_np, steps, data=(256, 32, 8), batches=None):
    jarch = arch
    jopt = JO.adamw(JS.cosine_schedule(3e-3, 2, 40))
    jp = jax.tree.map(jnp.asarray, params_np)
    js = jopt[0](jp)
    step = jit_step("train", j_make_train_step(jarch, jopt))
    out = []
    batches = batches or JSyntheticLM(*data)
    for batch in (next(it) for it in [batches] * steps):
        jp, js, m = step(jp, js, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        out.append(float(m["loss"]))
    return out


def _gathered(p):
    return tree.map(lambda x: x.full_tensor(), p)


def _jax_arch(arch):
    """The reference's ArchConfig with every field of the port's."""
    from repro.configs import base as JB
    kw = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)}
    kw["pattern"] = tuple(JB.Segment(s.blocks, s.repeat)
                          for s in arch.pattern)
    for name, cls in (("moe", JB.MoESpec), ("ssm", JB.SSMSpec),
                      ("mla", JB.MLASpec), ("encoder", JB.EncoderSpec)):
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return JB.ArchConfig(**kw)


@pytest.mark.parametrize("name", sorted(W.ARCHS))
def test_single_rank_trainer_equals_the_jax_step(single_rank, name):
    arch = W.ARCHS[name]
    mesh = M.make_host_mesh(device="cpu")
    tr = Trainer(arch, SHAPE, mesh, W.CFG)
    p, _ = tr.init_state()
    start = convert.to_numpy(_gathered(p))
    np.testing.assert_allclose(single_rank[name],
                               _jax_losses(_jax_arch(arch), start,
                                           _steps(name),
                                           batches=W.data(arch)),
                               rtol=1e-5, atol=0)


# the new tensor-parallel kinds' archs, and the leaves MP may still gather
# over `model` (the vocab-sharded embedding and head, full leaves)
TP_ARCHS = W.TP_ARCHS
GATHERED_OVER_MODEL = {"embed.embedding", "head.w", "head.b"}


@pytest.mark.parametrize("name", TP_ARCHS)
def test_mp_computes_on_each_ranks_share(request, name):
    """Under MP on (1, 4) every rank's SSD scans see H / 4 heads, its
    mamba2 mixers work on a quarter of x_proj's columns and every
    attention (self, encoder, shared, cross, the MTP block's) on a quarter
    of wq's, every latent attention on H / 4 heads and every MoE layer on
    E / 4 experts (tiny-moe's capacity drops tokens), and no leaf the
    specs shard over `model` is gathered over it but the embedding and
    head."""
    arch = W.ARCHS[name]
    recs = _ranks(request, name)["split"][name]
    assert len(recs) == 4
    kinds = {k for seg in arch.pattern for k in seg.blocks}
    for rank, rec in enumerate(recs):
        assert rec["mla_heads"] == ({arch.n_heads // 4} if kinds & {
            "mla", "mla_dense"} else set()), rank
        assert rec["experts"] == ({arch.moe.n_experts // 4} if kinds & {
            "mla", "moe_attn"} else set()), rank
        assert name != "tiny-moe" or rec["dropped"] > 0, rank
        if arch.ssm is not None:
            d_inner = arch.ssm.expand * arch.d_model
            assert rec["ssd_heads"] == {d_inner // arch.ssm.head_dim // 4}
            assert rec["x_proj"] == {(arch.d_model, d_inner // 4)}, rank
        else:
            assert rec["ssd_heads"] == set() and rec["x_proj"] == set()
        attends = any(k != "mamba2" for seg in arch.pattern
                      for k in seg.blocks)
        assert bool(rec["wq"]) == attends, rank
        for d_model, shape in rec["wq"]:
            assert shape == (d_model, d_model // 4), (rank, d_model, shape)
        assert rec["gathered_over_model"] <= GATHERED_OVER_MODEL, \
            (rank, rec["gathered_over_model"])
    if name == "tiny-shared":           # the shared block at 2 x d_model
        assert {dm for dm, _ in recs[0]["wq"]} == {2 * arch.d_model}


def _single_rank_grads(name):
    """-> (params, tokens, grads): arch ``name``'s step-1 gradients on a
    world of 1 from the Trainer's params and the first batch."""
    from repro_torch.runtime import steps as ST
    arch = W.ARCHS[name]
    tr = Trainer(arch, SHAPE, M.make_host_mesh(device="cpu"), W.CFG)
    p, _ = tr.init_state()
    params = _gathered(p)
    batch = next(W.data(arch))
    tok, lab = (torch.as_tensor(batch[k]) for k in ("tokens", "labels"))
    return params, tok, ST.loss_and_grads(ST.make_loss_fn(arch), params,
                                          tok, lab)[2]


@pytest.mark.parametrize("name", W.MOE_ARCHS)
def test_mp_grads_are_the_single_rank_grads(four_ranks_moe, name):
    """Every leaf's step-1 gradient under MP on (1, 4), reduced to its
    placement and gathered, against the single-rank step's at 1e-4 of
    its norm: the latent attention's q latent (its gather's backward
    sums the ranks' parts), the latents' partial leaves, the experts, the
    shared and dense MLPs, the MTP head."""
    _assert_single_rank_grads(name, four_ranks_moe["mp_grads"][name])


@pytest.mark.parametrize("name", W.MOE_ARCHS)
def test_hp_grads_are_the_single_rank_grads(four_ranks_moe, name):
    """The same under HP on (2, 2), whose batch is split over `data` and
    whose experts are split over `model`: the aux loss's means run over
    the global batch (``moe.batch_split``), their backward counting each
    rank's rows once, and its 1 / size over `model` still holds."""
    _assert_single_rank_grads(name, four_ranks_moe["hp_grads"][name])


def _assert_single_rank_grads(name, got):
    """``got`` ({leaf name: gathered gradient}) against the single-rank
    step's, each leaf at 1e-4 of its norm."""
    params, _, grads = _single_rank_grads(name)
    names = tree.names(params)
    assert sorted(got) == sorted(names)
    for leaf, want in zip(names, grads):
        want = want.numpy()
        err = np.linalg.norm(got[leaf] - want)
        assert err <= 1e-4 * np.linalg.norm(want) + 1e-9, (leaf, err)


@pytest.mark.parametrize("name", W.MOE_ARCHS)
@pytest.mark.parametrize("case", ["DP", "HP", "FS", "ASA"])
def test_moe_aux_loss_is_the_global_batchs(request, single_rank, name,
                                           case):
    """Where the batch is split over ranks, each MoE layer's aux loss is
    the global batch's, as the reference's under GSPMD: the losses and
    grad norms equal the single rank's at 1e-5, where the mean of the
    shards' aux losses differs from it by 1.2e-4 (tiny-moe) and 1.6e-4
    (tiny-mla-ep) on the first batch."""
    ranks = _ranks(request, name)
    for key in ("losses", "grad_norms"):
        want = (single_rank[name] if key == "losses" else
                single_rank[name, "grad_norms"])
        np.testing.assert_allclose(ranks[key][(name, case)], want,
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_aux_loss_gradient_reaches_the_router_once(four_ranks_moe):
    """The aux-loss trap: every `model` rank computes the MoE aux loss
    whole, and the router's gradient is summed over `model` (the gates
    reach it through each rank's own experts), so the aux term's backward
    is scaled by 1 / size on each rank.  tiny-mla-ep's router gradient
    under MP on (1, 4), gathered, equals the single-rank step's, and
    counting the aux term on all four ranks would add three times its
    share, far past the tolerance."""
    from repro_torch.models import transformer as T
    arch = W.ARCHS["tiny-mla-ep"]
    params, tok, grads = _single_rank_grads("tiny-mla-ep")
    names = tree.names(params)
    live = [x.detach().requires_grad_() for x in tree.leaves(params)]
    aux = T.lm_apply(tree.unflatten(params, live), arch, tok).aux
    routers = [i for i, n in enumerate(names) if ".router." in n]
    aux_grads = torch.autograd.grad(aux, [live[i] for i in routers])
    got = four_ranks_moe["mp_grads"]["tiny-mla-ep"]
    assert routers
    for i, ag in zip(routers, aux_grads):
        want = grads[i].numpy()
        np.testing.assert_allclose(got[names[i]], want, rtol=1e-4,
                                   atol=1e-7, err_msg=names[i])
        assert 3 * np.abs(ag.numpy()).max() > 100 * (
            1e-7 + 1e-4 * np.abs(want).max()), names[i]


EP_CASES = [(n, m) for n in W.MOE_ARCHS for m in W.EP_MODELS]


@pytest.mark.parametrize("name,model", EP_CASES)
def test_ep_major_trains_like_one(four_ranks_moe, single_rank, name, model):
    """EP-major HP on (4 / model, model): each rank routes its own rows
    and sends each expert's slots to its owner by all-to-all; the losses
    and grad norms equal the single rank's at 1e-5."""
    got = four_ranks_moe["ep"][(name, model)]
    np.testing.assert_allclose(got["losses"], single_rank[name], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["grad_norms"],
                               single_rank[name, "grad_norms"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,model", EP_CASES)
def test_ep_major_grads_are_the_single_rank_grads(four_ranks_moe, name,
                                                  model):
    """Every leaf's step-1 gradient under EP-major HP, gathered, at 1e-4
    of its norm: the expert stacks' (the all-to-all's backward brings
    every `data` rank's rows to the owner: summed over `pod` only and
    divided by the batch's shards), the router's (partial), the rest."""
    _assert_single_rank_grads(name, four_ranks_moe["ep"][(name,
                                                          model)]["grads"])


@pytest.mark.parametrize("name,model", EP_CASES)
def test_ep_major_stacks_are_their_specs_blocks(four_ranks_moe, name,
                                                model):
    """Each rank's expert stacks at init are the blocks the EP-major specs
    (``w_in`` / ``w_gate`` P(None, "data", None, "model"), ``w_out``
    P(None, "data", "model", None) with the repeat axis) give its
    coordinates, the reference's way."""
    stacks = four_ranks_moe["ep"][(name, model)]["stacks"]
    assert len(stacks) == 4
    for rank, got in enumerate(stacks):
        assert got, rank
        for leaf, (spec, ok) in got.items():
            assert ok, (rank, leaf)
            assert spec == ((None, "data", "model", None) if
                            leaf.endswith("w_out") else
                            (None, "data", None, "model")), (leaf, spec)


def _a2a_from_specs(arch, data: int) -> tuple:
    """(all-to-alls, bytes sent) of one train step with one microbatch
    and no remat: each MoE layer's dispatch and return in the forward,
    and their two in the backward, each an (E, B / data * C, D) fp32
    buffer at C = int(cf * K * S / E)."""
    m = arch.moe
    C = max(1, int(m.capacity_factor * m.top_k * SHAPE.seq_len /
                   m.n_experts))
    layers = sum(seg.repeat for seg in arch.pattern for k in seg.blocks
                 if k in ("mla", "moe_attn"))
    one = m.n_experts * (SHAPE.global_batch // data) * C * arch.d_model * 4
    return 4 * layers, 4 * layers * one


@pytest.mark.parametrize("name,model", EP_CASES)
def test_ep_major_all_to_alls_are_the_specs_count(four_ranks_moe, name,
                                                  model):
    got = four_ranks_moe["ep"][(name, model)]
    assert got["microbatches"] == 1
    count, nbytes = _a2a_from_specs(W.ARCHS[name], 4 // model)
    assert got["step1_a2a"] == {"count": count, "bytes": nbytes}
    assert got["steps_a2a"] == {"count": W.TP_STEPS * count,
                                "bytes": W.TP_STEPS * nbytes}


@pytest.mark.parametrize("name,model", EP_CASES)
def test_ep_major_forward_matches_the_reference(four_ranks_moe, name,
                                                model):
    """One EP-major forward of ``moe.routed`` (plus the side MLPs) on
    ``W.moe_inputs``' params and input against the reference's ``moe``
    on the CPU, fp32: the output at 1e-5 of its max, the aux loss (the
    global batch's) at 1e-5."""
    cfg, p, x = W.moe_inputs(name)
    want, want_aux = JM.moe(jax.tree.map(jnp.asarray, convert.to_numpy(p)),
                            JM.MoEConfig(**dataclasses.asdict(cfg)),
                            jnp.asarray(x))
    got = four_ranks_moe["ep_forward"][(name, model)]
    want = np.asarray(want)
    assert np.abs(got["out"] - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got["aux"], float(want_aux), rtol=1e-5)


def _reference_greedy(name, params_np):
    """The reference's jitted prefill and greedy decode steps on the
    contiguous cache, on the worker's params, prompt and frontend ->
    every token fed and the last one chosen, (B, steps + 1)."""
    arch = W.ARCHS[name]
    jarch = _jax_arch(arch)
    c = W.CONTIGUOUS
    toks, fe = W.contiguous_inputs(arch)
    jp = jax.tree.map(jnp.asarray, params_np)
    cache = JT.init_cache(jarch, c["batch"], c["max_len"], jnp.float32)
    lg, cache = jax.jit(JST.make_prefill_step(jarch))(
        jp, cache, jnp.asarray(toks), None if fe is None else
        jnp.asarray(fe))
    dec = jax.jit(JST.make_decode_step(jarch))
    fed = []
    for _ in range(c["steps"]):
        fed.append(np.asarray(jnp.argmax(lg, -1)))
        lg, cache = dec(jp, cache, jnp.asarray(fed[-1][:, None],
                                               jnp.int32))
    fed.append(np.asarray(jnp.argmax(lg, -1)))
    return np.stack(fed, 1)


@pytest.mark.parametrize("name", W.CONTIGUOUS_TP + W.CONTIGUOUS_MOE)
def test_contiguous_steps_through_tp_blocks(request, name):
    """``make_prefill_step`` and ``make_decode_step`` through the dry
    run's serving function under MP on (1, 4): every block its
    tensor-parallel function, on the contiguous caches placed by the
    plan's ``cache_specs`` (the attention caches a quarter of their rows
    a rank); every step's logits within 1e-5 of max |logit| of the
    unplaced steps', and the greedy tokens the reference's."""
    ranks = request.getfixturevalue(
        "four_ranks_moe" if name in W.CONTIGUOUS_MOE else "four_ranks_tp")
    got = ranks["contiguous"][name]
    assert got["rel"] <= 1e-5, got["rel"]
    assert np.array_equal(got["tokens"], got["unplaced_tokens"])
    assert got["block_fns"] and all(f.startswith("tp_")
                                    for f in got["block_fns"]), \
        got["block_fns"]
    max_len = W.CONTIGUOUS["max_len"]
    split = [(full, local) for full, local in got["cache_shapes"]
             if len(full) >= 4 and full[2] == max_len]
    kinds = {k for seg in W.ARCHS[name].pattern for k in seg.blocks}
    assert bool(split) == bool(kinds - {"mamba2", "cross_attn"}), kinds
    for full, local in split:
        assert local[2] * 4 == full[2], (full, local)
    np.testing.assert_array_equal(got["tokens"],
                                  _reference_greedy(name, got["params"]))


def test_gathers_by_hand_are_dtensors(four_ranks_tp):
    """The sharded step's all-gather (``sharded._gather_dims``, which
    every gather on use takes) lays shards out as DTensor's redistribute
    does, on (2, 2)."""
    got = four_ranks_tp["gathers_by_hand"]
    assert len(got) == 10 and all(ok for _, _, ok in got), got


def test_split_row_rmsnorm_on_four_ranks_is_the_whole_rows(four_ranks_tp):
    """The four ranks' columns of ``rmsnorm_split`` (a (6, 40) fp32 row
    split 10 a rank, loss sum(y * w)) against the reference's whole-row
    ``layers.rmsnorm`` and its ``jax.grad``, at 1e-5."""
    from repro.models import layers as JL
    rng = np.random.default_rng(3)
    x, w = (rng.standard_normal((6, 40)).astype(np.float32)
            for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(40)).astype(np.float32)

    def loss(x, s):
        return jnp.sum(JL.rmsnorm({"scale": s}, x) * w)
    want_y = np.asarray(JL.rmsnorm({"scale": scale}, x))
    want_dx, want_ds = jax.grad(loss, (0, 1))(x, scale)
    got = four_ranks_tp["split_rmsnorm"]
    for key, want, axis in (("y", want_y, 1), ("dx", want_dx, 1),
                            ("dscale", want_ds, 0)):
        np.testing.assert_allclose(
            np.concatenate([g[key] for g in got], axis=axis),
            np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# (d) the reference's trainer tests, re-pointed
# ---------------------------------------------------------------------------

TINY = port_arch(TINY_RT)


def _flat(p):
    return torch.cat([x.full_tensor().reshape(-1) for x in tree.leaves(p)])


def test_trainer_end_to_end(tmp_path):
    mesh = M.make_host_mesh(device="cpu")
    tr = Trainer(TINY, SHAPE, mesh,
                 TrainConfig(lr=3e-3, warmup_steps=2, total_steps=40,
                             checkpoint_every=10),
                 checkpoint_dir=str(tmp_path / "ck"))
    params, opt_state = tr.init_state()
    data = SyntheticLM(TINY.vocab, 32, 8)
    params, opt_state, hist = tr.train(params, opt_state, data, steps=20)
    assert len(hist) == 20
    assert hist[-1]["loss"] < hist[0]["loss"]
    tr.ckpt.wait()
    assert tr.ckpt.latest_step() == 20


def test_trainer_restart_resumes(tmp_path):
    mesh = M.make_host_mesh(device="cpu")
    cfg = TrainConfig(lr=1e-3, checkpoint_every=5, total_steps=40)
    tr = Trainer(TINY, SHAPE, mesh, cfg, checkpoint_dir=str(tmp_path / "ck"))
    params, opt_state = tr.init_state()
    data = SyntheticLM(TINY.vocab, 32, 8)
    params, opt_state, _ = tr.train(params, opt_state, data, steps=10)
    tr.ckpt.wait()

    tr2 = Trainer(TINY, SHAPE, mesh, cfg, checkpoint_dir=str(tmp_path / "ck"))
    p2, o2 = tr2.init_state(seed=1)
    p2, o2 = tr2.maybe_restore(p2, o2)
    assert tr2.step == 10
    torch.testing.assert_close(_flat(p2), _flat(params), rtol=1e-6,
                               atol=1e-6)


def test_crash_restart_reaches_same_state(tmp_path):
    """Train 12 steps with a checkpoint at 6; 'crash'; restart and replay
    6..12; the final state and loss equal the uninterrupted run's."""
    mesh = M.make_host_mesh(device="cpu")
    cfg = TrainConfig(lr=1e-3, checkpoint_every=6, total_steps=24)
    tr = Trainer(TINY, SHAPE, mesh, cfg, checkpoint_dir=str(tmp_path / "a"))
    p, o = tr.init_state()
    p, o, hist_ref = tr.train(p, o, SyntheticLM(TINY.vocab, 32, 8), steps=12)
    tr.ckpt.wait()

    tr1 = Trainer(TINY, SHAPE, mesh, cfg, checkpoint_dir=str(tmp_path / "b"))
    p1, o1 = tr1.init_state()
    p1, o1, _ = tr1.train(p1, o1, SyntheticLM(TINY.vocab, 32, 8), steps=7)
    tr1.ckpt.wait()

    tr2 = Trainer(TINY, SHAPE, mesh, cfg, checkpoint_dir=str(tmp_path / "b"))
    p2, o2 = tr2.init_state()
    p2, o2 = tr2.maybe_restore(p2, o2)
    assert tr2.step == 6
    data2 = SyntheticLM(TINY.vocab, 32, 8).skip(tr2.data_offset)
    p2, o2, hist2 = tr2.train(p2, o2, data2, steps=6)
    # the same ops on the same values: exact, not just close
    assert torch.equal(_flat(p), _flat(p2))
    assert hist_ref[-1]["loss"] == hist2[-1]["loss"]


def test_elastic_resize_preserves_state():
    """A same-size resize re-plans and re-places the live state; the five
    losses after it equal an uninterrupted run's exactly."""
    mesh = M.make_host_mesh(device="cpu")
    tr0 = Trainer(TINY, SHAPE, mesh, TrainConfig(lr=1e-3, total_steps=40))
    p0, o0 = tr0.init_state()
    p0, o0, href = tr0.train(p0, o0, SyntheticLM(TINY.vocab, 32, 8),
                             steps=10)

    tr = Trainer(TINY, SHAPE, mesh, TrainConfig(lr=1e-3, total_steps=40))
    p, o = tr.init_state()
    data = SyntheticLM(TINY.vocab, 32, 8)
    p, o, _ = tr.train(p, o, data, steps=5)
    p, o = tr.resize(M.make_host_mesh(device="cpu"), p, o)
    p, o, h2 = tr.train(p, o, data, steps=5)
    assert np.isfinite([m["loss"] for m in h2]).all()
    np.testing.assert_allclose([m["loss"] for m in h2],
                               [m["loss"] for m in href[5:]], rtol=0, atol=0)


def test_straggler_reassignment_preserves_coverage():
    """After a host dies, the union of assigned shards across live hosts
    still covers every shard exactly once."""
    loaders = [HostShardedLoader(
        lambda shard, n: SyntheticLM(100, 8, 2, seed=shard),
        n_hosts=4, host_id=h, heartbeat_timeout_s=0.05) for h in range(4)]
    now = time.monotonic()
    for ld in loaders:
        for h in range(4):
            ld.heartbeat(h, now if h != 3 else now - 10)   # host 3 dies
    assignments = []
    for h in range(3):
        next(loaders[h])
        assignments += loaders[h].assigned
    assert sorted(assignments) == [0, 1, 2, 3]


def test_anchor_losses_on_the_trainer():
    """ROADMAP's anchor: tiny-rt from the reference's PRNGKey(0) params,
    TrainConfig(lr=3e-3, warmup_steps=2, total_steps=40), SyntheticLM(256,
    32, 8); the Trainer's first five losses against the JAX step's on the
    same params at 1e-4, and against the recorded ones."""
    jparams = JT.init_lm(jax.random.PRNGKey(0), TINY_RT)
    params_np = jax.tree.map(np.asarray, jparams)
    mesh = M.make_host_mesh(device="cpu")
    tr = Trainer(TINY, SHAPE, mesh, TrainConfig(lr=3e-3, warmup_steps=2,
                                                total_steps=40))
    p, o = tr.init_state(params=convert.to_torch(params_np))
    p, o, hist = tr.train(p, o, SyntheticLM(256, 32, 8), steps=5)
    losses = [m["loss"] for m in hist]
    np.testing.assert_allclose(losses, _jax_losses(TINY_RT, params_np, 5),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(losses, ANCHOR_LOSSES, rtol=0, atol=1e-4)


def _trainer_state(steps=3, quantized=False, dtype=None):
    mesh = M.make_host_mesh(device="cpu")
    arch = TINY if dtype is None else dataclasses.replace(
        TINY, dtype=dtype, param_dtype=dtype)
    tr = Trainer(arch, SHAPE, mesh, TrainConfig(
        lr=3e-3, warmup_steps=2, total_steps=40, quantized_opt=quantized))
    p, o = tr.init_state()
    p, o, _ = tr.train(p, o, SyntheticLM(256, 32, 8), steps=steps)
    return tr, p, o


def test_fp32_checkpoint_interchanges_with_the_reference(tmp_path):
    tr, p, o = _trainer_state()
    state = {"params": _gathered(p), "opt": O.OptState(
        o.step, _gathered(o.mu), _gathered(o.nu))}
    save_pytree(tmp_path / "port", state, manifest_extra={"step": 3})
    # the reference reads the port's checkpoint into its own structure
    like = {"params": jax.tree.map(jnp.asarray, convert.to_numpy(
        state["params"])), "opt": JO.adamw(1e-3)[0](jax.tree.map(
            jnp.asarray, convert.to_numpy(state["params"])))}
    jtree, manifest = j_restore(tmp_path / "port", like)
    assert manifest["step"] == 3
    assert int(jtree["opt"].step) == 3
    for a, b in zip(jax.tree.leaves(jtree["params"]),
                    tree.leaves(state["params"])):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(jtree["opt"].nu),
                    tree.leaves(state["opt"].nu)):
        assert np.array_equal(np.asarray(a), b.numpy())
    # and the port reads the reference's, into DTensors on its mesh
    j_save(tmp_path / "ref", jtree, manifest_extra={"step": 3,
                                                    "data_offset": 3})
    back, m2 = restore_pytree(tmp_path / "ref", {"params": p, "opt": o})
    assert m2["data_offset"] == 3 and back["opt"].step == 3
    assert torch.equal(_flat(back["params"]), _flat(p))
    assert torch.equal(_flat(back["opt"].mu), _flat(o.mu))


def test_bf16_checkpoint_round_trip_is_bit_exact(tmp_path):
    tr, p, o = _trainer_state(steps=2, dtype="bfloat16")
    assert tree.leaves(p)[0].dtype == torch.bfloat16
    ck = CheckpointManager(tmp_path)
    ck.save(2, {"params": p, "opt": o}, extra={"data_offset": 2})
    ck.wait()
    manifest = (tmp_path / "step_0000000002" / "manifest.json").read_text()
    assert '"bfloat16"' in manifest and '"float32"' in manifest
    p2, o2 = tr.init_state(seed=5)
    back, m = ck.restore({"params": p2, "opt": o2})
    for a, b in zip(tree.leaves(back["params"]), tree.leaves(p)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.full_tensor().view(torch.int16),
                           b.full_tensor().view(torch.int16))
    assert torch.equal(_flat(back["opt"].nu), _flat(o.nu))


def test_int8_adamw_matches_the_reference():
    """adamw(quantized=True) for 4 steps from the same params and grads:
    params at 1e-6, the moments' int8 codes equal and scales at 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (300,), "b": (17, 33), "c": (4, 256)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jinit, jupd = JO.adamw(JS.cosine_schedule(1e-2, 2, 10), quantized=True)
    tinit, tupd = O.adamw(TS.cosine_schedule(1e-2, 2, 10), quantized=True)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jinit(jp), tinit(tp)
    for step in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32) * 0.1
             for k, s in shapes.items()}
        ju, js = jupd(jax.tree.map(jnp.asarray, g), js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = tupd({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                      ts, tp)
        tp = O.apply_updates(tp, tu)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            for jm, tm in ((js.mu[k], ts.mu[k]), (js.nu[k], ts.nu[k])):
                assert isinstance(jm, JQ.QLeaf) and isinstance(tm, Q.QLeaf)
                assert np.array_equal(np.asarray(jm.q), tm.q.numpy())
                np.testing.assert_allclose(tm.scale.numpy(),
                                           np.asarray(jm.scale), rtol=1e-6)
    assert ts.step == 4


def test_quantized_leaf_round_trip_matches_the_reference():
    x = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    for signed in (True, False):
        v = x if signed else np.abs(x)
        jq = JQ.QLeaf.from_dense(jnp.asarray(v), signed)
        tq = Q.QLeaf.from_dense(torch.from_numpy(v), signed)
        assert np.array_equal(np.asarray(jq.q), tq.q.numpy())
        np.testing.assert_array_equal(np.asarray(jq.dense()),
                                      tq.dense().numpy())


def test_train_launcher_smoke_and_restart(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-8b", "--smoke", "--steps", "4", "--device",
            "cpu", "--seq-len", "32", "--batch", "4", "--checkpoint-dir",
            str(tmp_path)]
    train.main(argv)
    out = capsys.readouterr().out
    assert "ASA plan [qwen3-8b-smoke x cli mesh=(1x1x1)]" in out
    assert out.strip().splitlines()[-1].startswith("done: loss ")
    assert (tmp_path / "step_0000000004" / "manifest.json").exists()
    train.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 4 (data offset 4)" in out
    assert (tmp_path / "step_0000000008").exists()
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "no-such-arch"])
    assert e.value.code == 2


def test_quickstart_smoke(capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu", "--smoke"])
    out = capsys.readouterr().out
    assert "step    2" in out and "final loss:" in out


def test_place_keeps_leaves_already_placed():
    """``sharding.place`` keeps a DTensor leaf already on its sharding's
    mesh and placements (a rank that drew its own shard never holds the
    whole leaf), and refuses one placed otherwise."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.core import sharding as SH
    mesh = M.make_host_mesh(device="cpu")
    ns = SH.NamedSharding(mesh, SH.P("model", None))
    x = torch.arange(6.0).reshape(2, 3)
    placed = SH.place({"w": x}, {"w": ns})["w"]
    assert SH.place({"w": placed}, {"w": ns})["w"] is placed
    other = DTensor.from_local(x, mesh, (Replicate(), Replicate()),
                               run_check=False)
    with pytest.raises(ValueError, match="not as its sharding"):
        SH.place({"w": other}, {"w": ns})


def test_host_mesh_and_production_mesh():
    mesh = M.make_host_mesh(device="cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert M.mesh_shape_of(mesh) == M.MeshShape(1, 1)
    with pytest.raises(ValueError, match="256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        M.make_host_mesh(n_devices=4, device="cpu")


def test_store_roundtrip_survives_empty_control_plane(tmp_path):
    """The reference's test of the same name, re-pointed: the scheduler's
    and the paged cache's host state ride in the manifest."""
    from repro_torch.serving.paged_cache import PagedCacheConfig, PagedKVCache
    from repro_torch.serving.scheduler import RequestScheduler
    sched = RequestScheduler(max_tokens_in_flight=7, footprint_cap=5)
    cfg = PagedCacheConfig(block_size=2, num_blocks=4,
                           max_blocks_per_seq=4, share_prefix=True)
    cache = PagedKVCache.host_only(cfg)
    t = {"w": torch.zeros((2,))}
    save_pytree(tmp_path / "ckpt", t,
                manifest_extra={"scheduler": sched.state_dict(),
                                "cache": cache.host_state_dict()})
    _r, manifest = restore_pytree(tmp_path / "ckpt", t)
    sched2 = RequestScheduler()
    sched2.load_state_dict(manifest["scheduler"], {})
    cache2 = PagedKVCache.host_only(cfg)
    cache2.load_host_state_dict(manifest["cache"])
    assert sched2.state_dict() == sched.state_dict()
    assert sched2.max_tokens_in_flight == 7
    assert cache2.host_state_dict() == cache.host_state_dict()


def test_npz_reader_reads_every_member_layout(tmp_path):
    """The checkpoint reader takes stored members from their offsets: C
    and Fortran order, 0-d, bf16 bit patterns; a compressed member goes
    through np.load."""
    from repro_torch.checkpoint.store import _npz_members
    want = {"c": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            "f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
            "z": np.asarray(7, np.int64),
            "h": np.arange(5, dtype=np.uint16)}
    np.savez(tmp_path / "a.npz", **want)
    get = _npz_members(tmp_path / "a.npz")
    for k, v in want.items():
        got = get(k)
        assert got.dtype == v.dtype and np.array_equal(got, v), k
    np.savez_compressed(tmp_path / "b.npz", x=want["c"])
    assert np.array_equal(_npz_members(tmp_path / "b.npz")("x"), want["c"])


def test_checkpoint_arrays_read_back_by_numpy_and_0d_leaves_stay_0d(
        tmp_path):
    """The checkpoint's npz is numpy's: np.load reads every leaf back
    with its dtype and shape (bf16 as uint16 bits, a 0-d leaf 0-d), and
    the port's reader restores a 0-d leaf 0-d."""
    t = {"gate": torch.zeros(()), "w": torch.arange(6.0).reshape(2, 3)
         .to(torch.bfloat16), "step": 5}
    save_pytree(tmp_path / "ck", t)
    with np.load(tmp_path / "ck" / "arrays.npz") as got:
        assert [got[f"a{i}"].shape for i in range(3)] == [(), (), (2, 3)]
        assert got["a2"].dtype == np.uint16
    back, _ = restore_pytree(tmp_path / "ck", t)
    assert back["gate"].shape == () and back["step"] == 5
    assert torch.equal(back["w"], t["w"])

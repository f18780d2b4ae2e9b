"""The port's training step (``repro_torch.runtime.steps.make_train_step``)
and its pieces against the JAX package, on the CPU.

The anchor case is the ROADMAP's: tiny-rt (2 layers, d 64, 4/2 heads,
d_ff 128, vocab 256), ``adamw(cosine_schedule(3e-3, 2, 40))``,
``SyntheticLM(256, 32, 8)``, params from ``init_lm(PRNGKey(0))`` with the
default RNG, converted leaf for leaf.  The reference is the mesh-free
``jit_step("train", make_train_step(arch, opt))`` (``Trainer.train``
raises on this jax).  Losses are held at 1e-5 relative; params and
moments with allclose at rtol 1e-4, atol 1e-6 (fp32).

One caveat on params, measured: AdamW's step is g / (sqrt(v) + eps) with
eps = 1e-8, so for an element whose gradient is itself ~1e-8 (a sum of
terms ~1e-4 that nearly cancel) the two frameworks' summation orders move
the step by a few percent of lr: in the anchor case one element of
``w_gate`` (grad 1.4566e-8 in JAX, 1.4729e-8 here) ends 4.1e-6 apart,
1.2e-6 beyond the allclose bound.  ``_assert_params_close`` therefore
holds every element at rtol 1e-4, atol 1e-6 except those whose reference
sqrt(v_hat) fell in (0, 10 * eps) at some step (19 of 106,816 elements
here); those are held at 1e-4 absolute, and at most 0.01 % of all
elements may leave the allclose bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduce_for_smoke
from repro.configs.base import ArchConfig, Segment
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro.runtime.steps import jit_step
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch import convert, tree
from repro_torch.data import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.optim import schedules as S
from repro_torch.runtime import steps as ST
from serving_fixtures import TINY_CROSS, TINY_ENCDEC
from torch_port_fixtures import frontend, opened, port_arch

TINY_RT = ArchConfig(name="tiny-rt", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                     pattern=(Segment(("attn",), 2),), dtype="float32",
                     param_dtype="float32")
ANCHOR_LOSSES = (6.0166, 5.8732, 5.5867, 5.5070, 5.3011)   # ROADMAP
# mamba2-780m cut to size by the reference's reduce_for_smoke (d_model 128,
# 16 heads of 16, d_state 16, 2 layers, vocab 512, tied embeddings, fp32)
# at its smoke chunk of 16
MAMBA2_SMOKE = reduce_for_smoke(get_arch("mamba2-780m"))
# zamba2-2.7b cut to size the same way (d_model 128, 2 applications of the
# shared block at width 256 with 4 heads of 64, 12 mamba2 layers of 16
# heads of 16, d_state 16, GeGLU, tied embeddings, fp32) at its smoke
# chunk of 16
ZAMBA2_SMOKE = reduce_for_smoke(get_arch("zamba2-2.7b"))
# deepseek-v3-671b cut the same way (2 mla_dense + 2 mla layers of MLA at
# LoRA ranks 64 / 32, 4 experts top-2 with sigmoid routing and a shared
# expert, the MTP head; capacity factor 2.0) and arctic-480b (2 moe_attn
# layers, 4 experts top-2 with softmax routing and a dense residual FFN)
DEEPSEEK_SMOKE = reduce_for_smoke(get_arch("deepseek-v3-671b"))
ARCTIC_SMOKE = reduce_for_smoke(get_arch("arctic-480b"))
# the arch of each run and its SyntheticLM(vocab, seq_len, batch); an
# arch with a frontend gets one in every batch (``torch_port_fixtures.
# frontend``, seeded by the step), and its cross_attn gates opened
RUNS = {"tiny-rt": (TINY_RT, (256, 32, 8)),
        "encdec": (TINY_ENCDEC, (256, 16, 4)),
        "cross": (TINY_CROSS, (256, 16, 4)),
        "mamba2": (MAMBA2_SMOKE, (512, 32, 8)),
        "mamba2-s128": (MAMBA2_SMOKE, (512, 128, 2)),
        "zamba2": (ZAMBA2_SMOKE, (512, 32, 4)),
        "deepseek": (DEEPSEEK_SMOKE, (512, 32, 4)),
        "arctic": (ARCTIC_SMOKE, (512, 32, 4))}
EPS = 1e-8          # adamw's


def _opts(kind: str):
    """(JAX optimizer, port optimizer) of one kind."""
    if kind == "sgd":
        return (JO.sgd_momentum(JS.cosine_schedule(3e-2, 2, 40)),
                O.sgd_momentum(S.cosine_schedule(3e-2, 2, 40)))
    return (JO.adamw(JS.cosine_schedule(3e-3, 2, 40)),
            O.adamw(S.cosine_schedule(3e-3, 2, 40)))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _with_chunk(arch: ArchConfig, chunk):
    return arch if chunk is None else dataclasses.replace(
        arch, ssm=dataclasses.replace(arch.ssm, chunk=chunk))


@functools.cache
def _run(steps: int, opt: str = "adamw", microbatches: int = 1,
         clip_norm: float = 1.0, impl: str = "xla", remat: str = "none",
         run: str = "tiny-rt", jax_chunk=None, port_chunk=None):
    """Both train steps from the same params over the same batches ->
    {"jax"/"port": (losses, grad norms, params, mu, nu)} as numpy, plus
    "sqrt_vhat_min": the reference's smallest nonzero sqrt(v_hat) per
    element over the steps (adamw only).  ``run`` names the arch and data
    (``RUNS``); ``jax_chunk`` / ``port_chunk`` set each side's SSD chunk."""
    arch, data = RUNS[run]
    jarch = _with_chunk(arch, jax_chunk)
    jopt, topt = _opts(opt)
    jparams = jax.tree.map(jnp.asarray, opened(
        JT.init_lm(jax.random.PRNGKey(0), jarch), jarch))
    tparams = convert.to_torch(_np_tree(jparams))
    jstate, tstate = jopt[0](jparams), topt[0](tparams)
    jstep = jit_step("train", j_make_train_step(
        jarch, jopt, microbatches=microbatches, clip_norm=clip_norm))
    tstep = ST.make_train_step(port_arch(_with_chunk(arch, port_chunk)),
                               topt, microbatches=microbatches,
                               clip_norm=clip_norm, impl=impl, remat=remat)
    jdata, tdata = JSyntheticLM(*data), SyntheticLM(*data)
    out = {"jax": ([], []), "port": ([], [])}
    vmin = None
    for i in range(steps):
        jb, tb = next(jdata), next(tdata)
        if arch.frontend:
            jb["frontend"] = tb["frontend"] = frontend(arch, data[2], i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in jb.items()})
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        assert tm["step"] == int(jm["step"]) == tstate.step
        for key, m in (("jax", jm), ("port", tm)):
            out[key][0].append(float(m["loss"]))
            out[key][1].append(float(m["grad_norm"]))
        if opt == "adamw":
            t = jstate.step
            s = [np.sqrt(np.asarray(v) / (1 - 0.95 ** float(t)))
                 for v in jax.tree.leaves(jstate.nu)]
            s = [np.where(x > 0, x, np.inf) for x in s]
            vmin = s if vmin is None else [np.minimum(a, b)
                                           for a, b in zip(vmin, s)]
    res = {"jax": out["jax"] + (jax.tree.leaves(_np_tree(jparams)),
                                jax.tree.leaves(_np_tree(jstate.mu)),
                                jax.tree.leaves(_np_tree(jstate.nu))
                                if jstate.nu is not None else None),
           "port": out["port"] + ([t.numpy() for t in tree.leaves(tparams)],
                                  [t.numpy() for t in tree.leaves(tstate.mu)],
                                  [t.numpy() for t in tree.leaves(tstate.nu)]
                                  if tstate.nu is not None else None),
           "sqrt_vhat_min": vmin}
    return res


def _assert_params_close(want, got, sqrt_vhat_min, skip=()):
    """allclose(rtol 1e-4, atol 1e-6) per element, except where the
    reference's Adam denominator sat near eps (module docstring); leaves
    at the indices ``skip`` are held for shape and dtype only."""
    n = n_out = 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape and w.dtype == g.dtype, i
        if i in skip:
            continue
        loose = (np.zeros(w.shape, bool) if sqrt_vhat_min is None
                 else sqrt_vhat_min[i] < 10 * EPS)
        diff = np.abs(w - g)
        out = diff > 1e-6 + 1e-4 * np.abs(w)
        assert not np.any(out & ~loose), i
        assert np.all(diff[loose] <= 1e-4), i
        n += w.size
        n_out += int(out.sum())
    assert n_out <= 1e-4 * n, (n_out, n)


def _assert_tree_close(want, got, rtol=1e-4, atol=1e-6):
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=str(i))


# ---------------------------------------------------------------------------
# the anchor case
# ---------------------------------------------------------------------------

def test_anchor_losses_match_the_roadmap_and_the_jax_step():
    r = _run(5)
    port, ref = r["port"][0], r["jax"][0]
    np.testing.assert_allclose(port, ANCHOR_LOSSES, rtol=1e-5)
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    np.testing.assert_allclose(r["port"][1], r["jax"][1], rtol=1e-5)


def test_anchor_params_and_moments_match_the_jax_step():
    r = _run(5)
    _assert_params_close(r["jax"][2], r["port"][2], r["sqrt_vhat_min"])
    _assert_tree_close(r["jax"][3], r["port"][3])
    _assert_tree_close(r["jax"][4], r["port"][4])


# ---------------------------------------------------------------------------
# variants, each against its JAX twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["microbatches2", "sgd_momentum",
                                     "clip_binds", "pallas"])
def test_train_step_variant_matches_jax(variant):
    kw = {"microbatches2": dict(microbatches=2),
          "sgd_momentum": dict(opt="sgd"),
          "clip_binds": dict(clip_norm=0.05),
          "pallas": dict(impl="pallas")}[variant]
    r = _run(3, **kw)
    np.testing.assert_allclose(r["port"][0], r["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(r["port"][1], r["jax"][1], rtol=1e-5)
    if variant == "clip_binds":       # the clip is what this case tests
        assert min(r["jax"][1]) > 0.05 * 10
    _assert_params_close(r["jax"][2], r["port"][2], r["sqrt_vhat_min"])
    _assert_tree_close(r["jax"][3], r["port"][3])


# ---------------------------------------------------------------------------
# mamba2: the SSD scan's gradient in the step, against the JAX step
# ---------------------------------------------------------------------------

def _assert_step_matches(r, skip=()):
    """The qwen anchor's tolerances: losses and grad norms at 1e-5
    relative, params by ``_assert_params_close`` (but the leaves at
    ``skip``), both moments at rtol 1e-4, atol 1e-6."""
    assert all(np.isfinite(r["port"][0])) and all(np.isfinite(r["port"][1]))
    np.testing.assert_allclose(r["port"][0], r["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(r["port"][1], r["jax"][1], rtol=1e-5)
    _assert_params_close(r["jax"][2], r["port"][2], r["sqrt_vhat_min"],
                         skip)
    _assert_tree_close(r["jax"][3], r["port"][3])
    _assert_tree_close(r["jax"][4], r["port"][4])


def test_mamba2_train_step_matches_jax():
    """reduce_for_smoke(mamba2-780m) at its chunk of 16, fp32, tied
    embeddings: 4 AdamW steps of the port's make_train_step against the
    mesh-free JAX step from the same params."""
    arch = port_arch(MAMBA2_SMOKE)
    assert arch.tie_embeddings and arch.ssm.chunk == 16
    _assert_step_matches(_run(4, run="mamba2"))


def test_mamba2_train_step_at_the_published_chunk_matches_jax():
    """The port's step at the published chunk of 128 (one chunk a 128-token
    sequence, where init's A = -(1..H) makes exp(cum_i - cum_j) overflow
    above the diagonal) stays finite and equals the JAX step at chunk 16:
    the chunked form does not depend on the chunk.  The JAX step itself is
    NaN at 128 (next test), so it is held at 16."""
    _assert_step_matches(_run(3, run="mamba2-s128", jax_chunk=16,
                              port_chunk=128))


def test_jax_mamba2_step_at_the_published_chunk_is_nan():
    """The reference fault this port does not copy (ROADMAP Queue 3):
    ``repro/models/mamba2.py::_ssd_chunked`` selects after the exp, so its
    gradient is NaN once exp(cum_i - cum_j) overflows above the diagonal.
    At chunk 128 the JAX step's first grad norm is NaN; this is why the
    port's step at 128 is held against the JAX step at 16."""
    arch = _with_chunk(MAMBA2_SMOKE, 128)
    jopt = _opts("adamw")[0]
    params = JT.init_lm(jax.random.PRNGKey(0), arch)
    step = jit_step("train", j_make_train_step(arch, jopt))
    batch = next(JSyntheticLM(*RUNS["mamba2-s128"][1]))
    _, _, m = step(params, jopt[0](params),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    assert np.isnan(float(m["grad_norm"]))


def test_zamba2_train_step_matches_jax():
    """reduce_for_smoke(zamba2-2.7b) at its chunk of 16: 3 AdamW steps of
    the port's make_train_step against the mesh-free JAX step from the
    same params.  The shared block's params take the sum of their grads
    over both applications, its attention runs the flash kernel's plain
    version under impl="pallas"."""
    arch = port_arch(ZAMBA2_SMOKE)
    assert arch.act == "geglu" and arch.ssm.chunk == 16
    _assert_step_matches(_run(3, run="zamba2", impl="pallas"))


@pytest.mark.parametrize("run", ["deepseek", "arctic"])
def test_moe_train_step_matches_jax(run):
    """4 AdamW steps of the port's make_train_step against the mesh-free
    JAX step from the same params: deepseek's smoke shape (MLA, sigmoid
    routing, a shared expert, the MTP loss term at weight 0.3 and the aux
    loss) and arctic's (softmax routing, a dense residual FFN, the aux
    loss; flash's plain version under impl="pallas").  loss - ce is the
    aux loss, > 0 on both sides."""
    r = _run(4, run=run, impl="pallas" if run == "arctic" else "xla")
    _assert_step_matches(r)
    arch = RUNS[run][0]
    assert arch.moe is not None and arch.mtp == (run == "deepseek")


@pytest.mark.parametrize("run", ["encdec", "cross"])
def test_frontend_train_step_matches_jax(run):
    """4 AdamW steps of the port's make_train_step against the mesh-free
    JAX step from the same params, a frontend in every batch: whisper's
    shape (the encoder over the frame embeddings inside the forward, under
    autograd; the decoder's self-attention through flash's plain version
    under impl="pallas") and llama-vision's (gated cross attention over
    the patch embeddings, gates opened at 0.5, so that they and the
    cross_attn blocks take gradients).

    One kind of leaf is held apart: the key projections' biases
    (``*.wk.b``, whisper's shape has attention biases).  A key bias adds
    q.b to every logit of a query's row, which the softmax cancels, so
    its gradient is 0 in exact arithmetic and what each framework computes
    is rounding noise (below 1e-6 of the step's largest grad, held here on
    the first batch); AdamW's g / (sqrt(v) + eps) turns that noise into
    steps of up to lr, of either sign, so those leaves' values after 4
    steps are noise in both and are held for shape and dtype only.  The
    losses, which they cannot move, are held at 1e-5 as every other
    run's."""
    r = _run(4, run=run, impl="pallas")
    arch = RUNS[run][0]
    params = JT.init_lm(jax.random.PRNGKey(0), arch)
    names = tree.names(convert.to_torch(_np_tree(params)))
    skip = [i for i, n in enumerate(names) if n.endswith("wk.b")]
    assert len(skip) == (3 if arch.attn_bias else 0)   # enc, self, cross
    _assert_step_matches(r, skip)
    if skip:
        b = next(SyntheticLM(*RUNS[run][1]))
        fe = frontend(arch, RUNS[run][1][2], 0)
        _, _, grads = ST.loss_and_grads(
            ST.make_loss_fn(port_arch(arch)),
            convert.to_torch(_np_tree(params)), torch.as_tensor(b["tokens"]),
            torch.as_tensor(b["labels"]), torch.from_numpy(fe))
        top = max(float(g.abs().max()) for g in grads)
        assert all(float(grads[i].abs().max()) <= 1e-6 * top for i in skip)
    if run == "cross":         # the gates moved off their opened value
        i = names.index("segments.0.b1.mlp_gate")
        assert np.all(r["port"][2][i] != 0.5)


@pytest.mark.parametrize("run", ["deepseek", "arctic"])
def test_loss_fn_terms_match_jax(run):
    """(total, ce) of make_loss_fn against the reference's on one batch:
    ce holds the MTP term for deepseek, total - ce is the MoE aux loss;
    both at 1e-6 relative."""
    from repro.runtime.steps import make_loss_fn as j_make_loss_fn
    jarch, data = RUNS[run]
    jparams = JT.init_lm(jax.random.PRNGKey(0), jarch)
    b = next(SyntheticLM(*data))
    jt, jc = j_make_loss_fn(jarch)(jparams, jnp.asarray(b["tokens"]),
                                   jnp.asarray(b["labels"]))
    tt, tc = ST.make_loss_fn(port_arch(jarch))(
        convert.to_torch(_np_tree(jparams)), torch.as_tensor(b["tokens"]),
        torch.as_tensor(b["labels"]))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)
    assert float(tt) > float(tc)


def _grads(remat: str, impl: str = "xla", run: str = "tiny-rt"):
    jarch, data = RUNS[run]
    arch = port_arch(jarch)
    params = convert.to_torch(_np_tree(JT.init_lm(jax.random.PRNGKey(0),
                                                  jarch)))
    b = next(SyntheticLM(*data))
    loss_fn = ST.make_loss_fn(arch, impl=impl, remat=remat)
    return ST.loss_and_grads(loss_fn, params, torch.as_tensor(b["tokens"]),
                             torch.as_tensor(b["labels"]))


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_remat_gives_the_grads_of_no_remat(remat):
    base = _grads("none")
    got = _grads(remat)
    assert float(got[0]) == float(base[0])
    for g, w in zip(got[2], base[2]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_mamba2_remat_gives_the_grads_of_no_remat(remat):
    """The mamba2 block (convs, softplus dt, the scan, D skip, gated norm)
    checkpointed per layer gives the grads of no remat, on the CPU's plain
    scan; the card runs the same with the scan's autograd Function
    (tests/test_torch_gpu.py::test_cuda_loss_backward_matches_cpu).  Each
    grad is held at 1e-6 of its max |value|: the CPU's multi-threaded
    sums may differ in the last bits between two runs of the same
    function, which moves an element near 0 by more than an elementwise
    rtol allows."""
    base = _grads("none", run="mamba2")
    got = _grads(remat, run="mamba2")
    torch.testing.assert_close(got[0], base[0], rtol=1e-6, atol=0)
    for g, w in zip(got[2], base[2]):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


@pytest.mark.parametrize("remat", ["full", "selective"])
def test_zamba2_remat_gives_the_grads_of_no_remat(remat):
    """zamba2's shape checkpointed per layer: each application's body
    closes over the shared block's params and the embeddings x0, and the
    grads of every leaf (the shared ones summed over the applications)
    equal those of no remat, each at 1e-6 of its max |value| (as the
    mamba2 case)."""
    base = _grads("none", impl="pallas", run="zamba2")
    got = _grads(remat, impl="pallas", run="zamba2")
    torch.testing.assert_close(got[0], base[0], rtol=1e-6, atol=0)
    for g, w in zip(got[2], base[2]):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


def test_selective_remat_saves_the_dense_products_only():
    from torch.utils.checkpoint import CheckpointPolicy
    assert T._save_dots(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default,
               torch.ops.aten.mul.Tensor):
        assert T._save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_unknown_remat_and_unported_options_raise():
    arch = port_arch(TINY_RT)
    params = T.init_lm(arch, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        T.lm_apply(params, arch, torch.zeros((1, 4), dtype=torch.long),
                   remat="dots")
    # int8 moments are ported now: the state holds a QLeaf per leaf
    qstate = O.adamw(1e-3, quantized=True)[0](params)
    assert all(isinstance(x, O.QLeaf) for x in tree.leaves(qstate.mu))
    step = ST.make_train_step(arch, O.adamw(1e-3), microbatches=3)
    batch = next(SyntheticLM(256, 8, 4))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, O.adamw(1e-3)[0](params), batch)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,masked", [(256, False), (300, False),
                                      (300, True), (256, True)])
def test_lm_loss_matches_jax(V, masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, V)).astype(np.float32) * 3
    labels = rng.integers(0, 256, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.4).astype(np.float32) if masked else None
    want = JT.lm_loss(jnp.asarray(logits), jnp.asarray(labels), 256,
                      None if mask is None else jnp.asarray(mask))
    tl = torch.from_numpy(logits).requires_grad_()
    got = T.lm_loss(tl, torch.from_numpy(labels), 256,
                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jg = jax.grad(lambda lg: JT.lm_loss(
        lg, jnp.asarray(labels), 256,
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    got.backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), atol=1e-7)
    if V > 256:
        assert float(tl.grad[..., 256:].abs().max()) == 0.0


def test_lm_loss_with_an_empty_mask_is_zero():
    logits = torch.zeros((1, 3, 8))
    got = T.lm_loss(logits, torch.zeros((1, 3), dtype=torch.long), 8,
                    torch.zeros((1, 3)))
    assert float(got) == 0.0


def _random_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
            "b": [rng.standard_normal((3,)).astype(np.float32),
                  rng.standard_normal((2, 2, 4)).astype(np.float32)],
            "c": rng.standard_normal((6,)).astype(np.float32) * 1e-3}


def test_global_norm_and_clip_match_jax():
    g = _random_tree(1)
    jg, tg = jax.tree.map(jnp.asarray, g), convert.to_torch(g)
    np.testing.assert_allclose(float(O.global_norm(tg)),
                               float(JO.global_norm(jg)), rtol=1e-6)
    for max_norm in (1e9, 0.5):
        jc, jn = JO.clip_by_global_norm(jg, max_norm)
        tg = convert.to_torch(g)            # clipping scales it in place
        tc, tn = O.clip_by_global_norm(tg, max_norm)
        assert all(c is t for c, t in zip(tree.leaves(tc), tree.leaves(tg)))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(jax.tree.leaves(_np_tree(jc)),
                           [t.numpy() for t in tree.leaves(tc)], rtol=1e-6,
                           atol=0)
    with pytest.raises(ValueError, match="fp32"):
        O.clip_by_global_norm({"w": torch.ones(3, dtype=torch.bfloat16)},
                              0.5)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_steps_match_jax_on_a_random_tree(kind):
    jopt, topt = _opts(kind)
    params = _random_tree(2)
    jp, tp = jax.tree.map(jnp.asarray, params), convert.to_torch(params)
    js, ts = jopt[0](jp), topt[0](tp)
    for step in range(4):
        g = _random_tree(10 + step)
        ju, js = jopt[1](jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt[1](convert.to_torch(g), ts, tp)
        jp = JO.apply_updates(jp, ju)
        tp = O.apply_updates(tp, tu)
        assert ts.step == int(js.step) == step + 1
        _assert_tree_close(jax.tree.leaves(_np_tree(ju)),
                           [t.numpy() for t in tree.leaves(tu)], rtol=1e-5,
                           atol=1e-9)
    _assert_tree_close(jax.tree.leaves(_np_tree(jp)),
                       [t.numpy() for t in tree.leaves(tp)], rtol=1e-6,
                       atol=1e-9)
    _assert_tree_close(jax.tree.leaves(_np_tree(js.mu)),
                       [t.numpy() for t in tree.leaves(ts.mu)], rtol=1e-6,
                       atol=1e-12)


def test_apply_updates_keeps_dtypes_and_writes_in_place():
    p = {"w": torch.ones(3, dtype=torch.bfloat16), "s": torch.zeros(2)}
    u = {"w": torch.full((3,), 0.25), "s": torch.full((2,), -1.0)}
    want = {k: (p[k].float() + u[k]).to(p[k].dtype) for k in p}
    before = dict(p)
    same = O.apply_updates(p, u)
    assert same is p and all(p[k] is before[k] for k in p)
    assert p["w"].dtype == torch.bfloat16 and p["s"].dtype == torch.float32
    assert all(torch.equal(p[k], want[k]) for k in p)
    assert float(u["w"][0]) == 0.25 and float(u["s"][0]) == -1.0


@pytest.mark.parametrize("args", [(3e-3, 2, 40), (3e-4, 1, 10),
                                  (1e-3, 0, 50), (2.5e-4, 10, 1000)])
def test_schedules_are_bit_for_bit_the_reference(args):
    pairs = [(JS.cosine_schedule(*args), S.cosine_schedule(*args)),
             (JS.linear_warmup(*args[:2]), S.linear_warmup(*args[:2]))]
    for jfn, tfn in pairs:
        for step in range(51):
            want = np.float32(jfn(jnp.int32(step)))
            got = np.float32(tfn(step))
            assert got.view(np.int32) == want.view(np.int32), (step, got,
                                                               want)


def test_synthetic_lm_batches_equal_the_reference():
    for seed, offset in ((0, 0), (3, 7)):
        j = JSyntheticLM(256, 32, 8, seed=seed).skip(offset)
        t = SyntheticLM(256, 32, 8, seed=seed, start_step=offset)
        for _ in range(3):
            jb, tb = next(j), next(t)
            assert jb.keys() == tb.keys()
            for k in jb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
        assert t.step == offset + 3


def test_unflatten_keeps_no_reference_to_its_values():
    """The train step hands its fp32 grads (gigabytes on the card) through
    ``tree.unflatten``; they must be freed as soon as the step drops them,
    not when the garbage collector next runs."""
    import gc
    import weakref
    values = [torch.zeros(3), torch.zeros(2)]
    ref = weakref.ref(values[0])
    gc.disable()
    try:
        out = tree.unflatten({"a": 0, "b": [0]}, values)
        assert out["a"] is values[0] and out["b"][0] is values[1]
        del values, out
        assert ref() is None
    finally:
        gc.enable()


def test_tree_names_follow_the_leaf_order():
    t = {"b": [torch.zeros(1), (torch.ones(1),)], "a": {"y": torch.zeros(2),
                                                      "x": torch.zeros(3)}}
    assert tree.names(t) == ["a.x", "a.y", "b.0", "b.1.0"]
    assert [x.numel() for x in tree.leaves(t)] == [3, 2, 1, 1]
    assert tree.names(torch.zeros(1)) == [""]

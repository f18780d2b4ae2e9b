"""The paper's own experiment in the port (``repro_torch.models.vision``,
``data.SyntheticImages``, ``examples.paper_repro`` and
``examples.paper_repro_asa``) against the JAX package, on the CPU, fp32.

Params come from the JAX init and are converted leaf for leaf; images are
made with numpy from a seed and handed to both.  The port's ViT attends
through ``kernels.ops.flash_attention(causal=False)``, whose CPU path is
its plain version; that plain version is also held against the Pallas
kernel in interpret mode at ViT's shapes.

Tolerances: logits at atol = rtol = 1e-5 (the ViT), 1e-5 of max |ref|
(ResNet, whose logits are sums over a batch-normalised 4 x 4 grid); one
train step's loss at 1e-5, each gradient and each updated param leaf at
1e-5 * max(1, max |ref|), but for the elements whose clipped reference
gradient lies below 10 * eps = 1e-7.  AdamW's first step moves a param
by lr * g / (|g| + eps), whose slope in g is up to lr / eps = 1e5: there
the summation orders' ~1e-9 difference in g moves the update by up to
~1e-4 (the ViT's key biases, ``attn.wk.b``, are all such elements: their
gradient is 0 in exact arithmetic, softmax being shift invariant).  Those
elements are held to that slope: |param difference| <= lr / eps * |clipped
gradient difference| + 1e-6.  The
paper tables are pure Python and held exactly.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import paper_repro as JPR
from repro.data import SyntheticImages as JSyntheticImages
from repro.kernels import flash_attention as JFA
from repro.models import vision as JV
from repro.optim import optimizers as JO
from repro_torch import convert, tree
from repro_torch.data import SyntheticImages
from repro_torch.examples import paper_repro as PR
from repro_torch.examples import paper_repro_asa as ASA
from repro_torch.kernels import ops as kops
from repro_torch.models import vision as V

SMALL_VIT = dict(d_model=64, n_layers=2, n_heads=4, d_ff=128, n_classes=10)
SMALL_RESNET = dict(stage_sizes=(1, 1, 1), width=8, n_classes=10)
LR = 1e-3
EPS = 1e-8                         # adamw's
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _images(seed, batch, size):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, size, size, 3)).astype(np.float32)


def _labels(seed, batch, n_classes):
    return np.random.default_rng(seed + 100).integers(
        0, n_classes, batch).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_model(kind, over=()):
    """(jax cfg, jax params) of the small config, ``over`` as (field,
    value) pairs; JAX params are immutable, so they are shared."""
    if kind == "vit":
        cfg = JV.ViTConfig(**{**SMALL_VIT, **dict(over)})
        init = JV.init_vit
    else:
        cfg = JV.ResNetConfig(**{**SMALL_RESNET, **dict(over)})
        init = JV.init_resnet
    # one compiled init (eagerly, each of ResNet's draws compiles alone)
    return cfg, jax.jit(init, static_argnums=1)(jax.random.PRNGKey(0), cfg)


def _models(kind, **over):
    """(jax params, fresh torch params converted from them, jax apply,
    torch apply)."""
    jcfg, jp = _jax_model(kind, tuple(sorted(over.items())))
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    if kind == "vit":
        tcfg = V.ViTConfig(**dataclasses.asdict(jcfg))
        return (jp, tp, lambda p, x: JV.vit_apply(p, jcfg, x),
                lambda p, x: V.vit_apply(p, tcfg, x))
    tcfg = V.ResNetConfig(**dataclasses.asdict(jcfg))
    return (jp, tp, lambda p, x: JV.resnet_apply(p, jcfg, x),
            lambda p, x: V.resnet_apply(p, tcfg, x))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fresh", "skip", "start_step"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_images_batches_are_bit_equal(seed, mode):
    kw = dict(n_classes=100, image_size=16, batch=8, seed=seed)
    if mode == "start_step":
        kw["start_step"] = 4
    j, t = JSyntheticImages(**kw), SyntheticImages(**kw)
    if mode == "skip":
        j.skip(5), t.skip(5)
    np.testing.assert_array_equal(t.class_means, j.class_means)
    for _ in range(3):
        a, b = next(t), next(j)
        assert a["images"].dtype == np.float32 and a["labels"].dtype == np.int32
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert t.step == j.step


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def test_init_vit_and_resnet_trees_match_the_reference():
    for kind in ("vit", "resnet"):
        jp = _jax_model(kind)[1]
        if kind == "vit":
            tp = V.init_vit(V.ViTConfig(**SMALL_VIT), device="cpu")
        else:
            tp = V.init_resnet(V.ResNetConfig(**SMALL_RESNET), device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(jp)
        assert tree.names(tp) == [
            ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in jl]
        assert [tuple(t.shape) for t in tree.leaves(tp)] == \
            [x.shape for _, x in jl]
        assert all(t.dtype == torch.float32 for t in tree.leaves(tp))


@pytest.mark.parametrize("patch", [4, 8])
def test_vit_logits_match_jax(patch):
    jp, tp, japply, tapply = _models("vit", patch=patch)
    x = _images(1, 3, 32)
    want = np.asarray(japply(jp, jnp.asarray(x)))
    got = tapply(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_vit_attends_through_the_flash_wrapper(monkeypatch):
    """Every layer's self-attention calls ``kops.flash_attention`` once,
    bidirectional, at head dim d_model / n_heads."""
    calls = []
    real = kops.flash_attention

    def spy(q, k, v, *, scale=None, causal=True):
        calls.append((tuple(q.shape), scale, causal))
        return real(q, k, v, scale=scale, causal=causal)
    monkeypatch.setattr(kops, "flash_attention", spy)
    _, tp, _, tapply = _models("vit")
    tapply(tp, torch.from_numpy(_images(2, 2, 32)))
    assert calls == [((2, 65, 4, 16), 0.25, False)] * 2


@pytest.mark.parametrize("shape", [(2, 4, 65, 16), (2, 12, 65, 64)])
def test_bidirectional_flash_matches_pallas_interpret(shape):
    B, H, S, D = shape
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, (B, H, S, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        interpret=True))
    # the port's adapter takes the model's (B, S, H, D) layout
    got = kops.flash_attention(
        *(torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)),
        scale=D ** -0.5, causal=False).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [32, 15])
def test_resnet_logits_match_jax(size):
    """32: the stride-2 3x3 convs pad XLA's (0, 1); 15: (1, 1); every
    stage's first block takes the ``proj`` path."""
    jp, tp, japply, tapply = _models("resnet", image_size=size)
    x = _images(3, 4, size)
    want = np.asarray(japply(jp, jnp.asarray(x)))
    got = tapply(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,k,s,pads", [(32, 3, 2, (0, 1)),
                                        (15, 3, 2, (1, 1)),
                                        (16, 3, 1, (1, 1)),
                                        (16, 1, 2, (0, 0)),
                                        (15, 1, 2, (0, 0))])
def test_same_padding_is_xlas(n, k, s, pads):
    assert V._same_pads(n, k, s) == pads


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _jax_step(apply_fn):
    """The reference demo's ``step`` (examples/paper_repro_asa.py) for any
    apply_fn -> (opt_init, step) with step returning the grads too."""
    opt_init, opt_update = JO.adamw(LR, weight_decay=0.01)

    @jax.jit
    def step(params, state, images, labels):
        def loss_fn(p):
            logits = apply_fn(p, images)
            logp = jax.nn.log_softmax(logits)
            nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean()
            acc = (jnp.argmax(logits, -1) == labels).mean()
            return nll, acc
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        clipped, _ = JO.clip_by_global_norm(grads, 1.0)
        upd, state2 = opt_update(clipped, state, params)
        return JO.apply_updates(params, upd), state2, loss, acc, grads
    return opt_init, step


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_one_train_step_matches_jax(kind):
    jp, tp, japply, tapply = _models(kind)
    x, y = _images(4, 8, 32), _labels(4, 8, 10)
    jinit, jstep = _jax_step(japply)
    jnew, _, jloss, jacc, jgrads = jstep(jp, jinit(jp), jnp.asarray(x),
                                         jnp.asarray(y))
    # the grads before the clip, as the reference computes them
    tloss, tacc, tgrads = ASA.ST.loss_and_grads(
        ASA.image_loss(tapply), tp, torch.from_numpy(x), torch.from_numpy(y))
    tinit, tstep = ASA.make_image_step(tapply)
    tnew, _, loss, acc = tstep(tp, tinit(tp), torch.from_numpy(x),
                               torch.from_numpy(y))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1, float(jloss))
    assert float(tloss) == float(loss)
    assert float(acc) == float(jacc) == float(tacc)
    gnorm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                              for g in jax.tree.leaves(jgrads))))
    clip = min(1.0, 1.0 / (gnorm + 1e-9))
    n_near = 0
    for n, g, jg, p, jp_ in zip(tree.names(tp), tgrads,
                                jax.tree.leaves(jgrads), tree.leaves(tnew),
                                jax.tree.leaves(jnew)):
        _close(g.numpy(), jg, f"grad {n}")
        want, jg = np.asarray(jp_), np.asarray(jg)
        diff = np.abs(p.numpy() - want)
        near_eps = np.abs(jg) * clip < 10 * EPS
        assert np.all(diff[~near_eps] <= 1e-5 * max(1, np.abs(want).max())), n
        slope = LR / EPS * np.abs(g.numpy() - jg) * clip + 1e-6
        assert np.all(diff[near_eps] <= slope[near_eps]), n
        n_near += int(near_eps.sum())
    if kind == "vit":             # the key biases at least
        assert n_near >= tp["layers"]["attn"]["wk"]["b"].numel()


def test_reduced_vit_five_losses_match_jax():
    cfg = ASA.DEMO_VIT
    jcfg = JV.ViTConfig(**{f: getattr(cfg, f) for f in (
        "image_size", "patch", "d_model", "n_layers", "n_heads", "d_ff",
        "n_classes")})
    jp = JV.init_vit(jax.random.PRNGKey(0), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    jinit, jstep = _jax_step(lambda p, x: JV.vit_apply(p, jcfg, x))
    tinit, tstep = ASA.make_image_step(lambda p, x: V.vit_apply(p, cfg, x))
    js, ts = jinit(jp), tinit(tp)
    data = SyntheticImages(n_classes=10, batch=16)
    got, want = [], []
    for _ in range(5):
        b = next(data)
        jp, js, jl, _, _ = jstep(jp, js, jnp.asarray(b["images"]),
                                 jnp.asarray(b["labels"]))
        tp, ts, tl, _ = tstep(tp, ts, torch.from_numpy(b["images"]),
                              torch.from_numpy(b["labels"]))
        got.append(float(tl))
        want.append(float(jl))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the paper's tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["vit", "resnet50"])
def test_paper_components_equal_field_by_field(model):
    fn = "vit_b16_components" if model == "vit" else "resnet50_components"
    for batch in (PR.BATCH, 64):
        want = getattr(JPR, fn)(batch)
        got = getattr(PR, fn)(batch)
        assert [type(c).__name__ for c in got] == ["Component"] * len(want)
        assert [vars(c) for c in got] == [vars(c) for c in want]


@pytest.mark.parametrize("fn", ["table1", "fig2_scalability", "fig3_comm",
                                "fig5_memory", "fig6_strategy_map"])
@pytest.mark.parametrize("model", ["vit", "resnet50"])
def test_paper_tables_equal_exactly(model, fn):
    def plain(x):   # Strategy enums compared by value
        if isinstance(x, dict):
            return {str(k): plain(v) for k, v in x.items()}
        return x
    assert plain(getattr(PR, fn)(model)) == plain(getattr(JPR, fn)(model))
    assert PR.PAPER_TABLE1 == JPR.PAPER_TABLE1


def test_gpu_step_takes_the_h100_profile():
    from repro.core.hardware import HardwareProfile
    from repro_torch.core.hardware import H100_SXM
    jh100 = HardwareProfile(**dataclasses.asdict(H100_SXM))
    comps, jcomps = PR.vit_b16_components(64), JPR.vit_b16_components(64)
    dp = {c.name: PR.Strategy.DP for c in comps}
    jdp = {c.name: JPR.Strategy.DP for c in jcomps}
    assert PR._gpu_step(comps, n_gpus=1, dp=1, pp=1, strategies=dp,
                        hw=H100_SXM) == \
        JPR._gpu_step(jcomps, n_gpus=1, dp=1, pp=1, strategies=jdp,
                      hw=jh100)


def test_paper_repro_asa_cpu_smoke_exits_0():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.paper_repro_asa",
         "--device", "cpu", "--smoke"], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--- resnet50 ---" in r.stdout and "--- vit ---" in r.stdout
    assert "step    2  loss" in r.stdout

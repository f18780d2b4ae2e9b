"""The contiguous decode cache of the PyTorch port, held against the JAX
package on the CPU: ``transformer.init_cache``'s tree, the cache specs at
published widths, ``runtime/steps.py``'s ``make_prefill_step`` /
``make_decode_step`` on converted params, decode against the forward, and
the steps' freedom from host syncs.

Params are the reference's ``init_lm`` converted leaf for leaf
(``repro_torch.convert``); tokens and frontends come from numpy seeds.
Tolerances: the port's steps against the reference's, in float32 at
smoke widths, rel 1e-5 of max |logit| (both sides compute the same
float32 arithmetic; the reference's own decode-vs-forward bound is
5e-3); the decode-vs-forward twin at the reference's 5e-3.
"""
from __future__ import annotations

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduce_for_smoke
from repro.models import transformer as JT
from repro.runtime import steps as JST
from repro_torch import tree
from repro_torch.analysis.lint import Linter
from repro_torch.core import sharding as TSH
from repro_torch.core.costmodel import MeshShape
from repro_torch.core.strategy import Strategy
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as ST

import torch_port_fixtures as FX

REPO = pathlib.Path(__file__).resolve().parents[1]
STEP_REL = 1e-5          # port step vs reference step, float32
FORWARD_REL = 5e-3       # decode vs forward, the reference's bound
FAMILIES = ("qwen3-8b", "mamba2-780m", "zamba2-2.7b", "deepseek-v3-671b",
            "whisper-medium", "llama-3.2-vision-90b")


def _rel(want, got) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(want - np.asarray(got))) /
                 (np.max(np.abs(want)) + 1e-9))


def _leaf_facts(leaves) -> list:
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_cache_tree_matches_reference(name):
    """Every arch at smoke widths: the same tree (paths in JAX's
    flattening order), shapes and dtypes as the reference's
    ``init_cache`` (bfloat16 KV, float32 mamba2 state, int32 ``pos``)."""
    arch = reduce_for_smoke(ARCHS[name])
    want = jax.eval_shape(lambda: JT.init_cache(arch, 3, 40, jnp.bfloat16))
    got = T.init_cache(FX.port_arch(arch), 3, 40, device="meta")
    paths = [jax.tree_util.keystr(p).replace("['", ".").replace("']", "")
             .replace("[", ".").replace("]", "")
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert ["." + n for n in tree.names(got)] == paths
    assert _leaf_facts(tree.leaves(got)) == \
        _leaf_facts(jax.tree.leaves(want))


def _check_divisible(spec, shape, where):
    sizes = {"data": 16, "model": 16, "pod": 1}
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        total = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            total *= sizes[a]
        assert shape[i] % total == 0, (where, spec, shape)


class _EveryMP(dict):
    """An assignment of MP to every component (the reference test's
    ``{c.name: Strategy.MP for c in comps}``, without planning the
    published width's components)."""

    def get(self, key, default=None):
        return Strategy.MP


@pytest.mark.parametrize("name", ["qwen3-8b", "zamba2-2.7b",
                                  "deepseek-v3-671b", "whisper-medium",
                                  "llama-3.2-vision-90b"])
def test_cache_specs_mirror_cache_tree(name):
    """Twin of the reference's test of the same name: at published widths
    (built on the meta device), ``cache_specs`` under MP has the cache
    tree's structure and every sharded dim divides."""
    arch = FX.port_arch(ARCHS[name])
    cache = T.init_cache(arch, 128, 256, device="meta")
    specs = TSH.cache_specs(arch, _EveryMP(), MeshShape(16, 16), 128)
    leaves = tree.leaves(cache)
    spec_leaves = TSH.spec_leaves(specs)
    assert len(spec_leaves) == len(leaves)
    assert TSH.map_specs(lambda s: 0, specs) == tree.map(lambda x: 0, cache)
    for leaf, spec in zip(leaves, spec_leaves):
        _check_divisible(spec, tuple(leaf.shape), name)


def _frontend(arch, B):
    return FX.frontend(arch, B, 5) if arch.frontend else None


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_decode_match_reference(name):
    """``make_prefill_step`` on 12 tokens, then three ``make_decode_step``
    calls, against the reference's steps on the same converted params,
    tokens and frontend: every step's logits within STEP_REL; the
    caches' ``pos`` advanced on the device."""
    arch = reduce_for_smoke(ARCHS[name])
    parch = FX.port_arch(arch)
    jp = FX.jax_params(arch, open_gates=arch.frontend == "vision")
    tp = FX.torch_params(arch, open_gates=arch.frontend == "vision")
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(
        0, arch.vocab, (B, S + 3)).astype(np.int32)
    fe = _frontend(arch, B)
    jc = JT.init_cache(arch, B, 32, jnp.float32)
    tc = T.init_cache(parch, B, 32, device="cpu", dtype=torch.float32)
    want, jc = jax.jit(JST.make_prefill_step(arch))(
        jp, jc, jnp.asarray(toks[:, :S]),
        None if fe is None else jnp.asarray(fe))
    prefill = ST.make_prefill_step(parch)
    decode = ST.make_decode_step(parch)
    with torch.no_grad():
        got, tc2 = prefill(tp, tc, torch.as_tensor(toks[:, :S]),
                           None if fe is None else torch.as_tensor(fe))
    assert tc2 is tc
    rels = [_rel(want, got)]
    jdec = jax.jit(JST.make_decode_step(arch))
    for i in range(3):
        t = toks[:, S + i:S + i + 1]
        want, jc = jdec(jp, jc, jnp.asarray(t))
        with torch.no_grad():
            got, _ = decode(tp, tc, torch.as_tensor(t))
        rels.append(_rel(want, got))
    assert max(rels) < STEP_REL, (name, rels)
    for x, w in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        if x.dtype == torch.int32:               # every pos: S + 3
            assert x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))
            assert int(x.reshape(-1)[0]) == S + 3


def test_decode_matches_forward_all_families():
    """Twin of the reference's test of the same name, on the port alone
    (its own ``init_lm`` weights): the forward's logits at position S
    equal a prefill of S tokens then one decode step, within
    FORWARD_REL."""
    for name in ("qwen3-8b", "mamba2-780m", "zamba2-2.7b",
                 "deepseek-v3-671b", "whisper-medium"):
        arch = FX.port_arch(reduce_for_smoke(ARCHS[name]))
        params = T.init_lm(arch, device="cpu", seed=2)
        B, S = 2, 12
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, arch.vocab, (B, S + 1)))
        fe = None
        if arch.frontend == "vision":
            fe = torch.ones((B, arch.n_img_tokens, arch.d_model))
        elif arch.frontend == "audio":
            fe = torch.ones((B, arch.encoder.seq_len, arch.d_model))
        with torch.no_grad():
            full = T.lm_apply(params, arch, toks, frontend=fe)
            cache = T.init_cache(arch, B, 32, device="cpu",
                                 dtype=torch.float32)
            T.lm_apply(params, arch, toks[:, :S], cache=cache, frontend=fe)
            dec = T.lm_apply(params, arch, toks[:, S:], cache=cache)
        rel = _rel(full.logits[:, S].numpy(), dec.logits[:, 0].numpy())
        assert rel < FORWARD_REL, (name, rel)


def test_contiguous_steps_have_no_host_sync():
    """``pos`` stays on the device: the CPU cannot run CUDA's sync check,
    so reprolint's ``step-host-sync`` rule holds the new steps and
    everything they call.  The rule reaches the contiguous path — a
    ``.item()`` put into ``layers.cache_rows`` is found, reached from a
    step function — and the port's tree has no such finding."""
    rules = {"step-host-sync", "step-tensor-branch"}
    src = REPO / "src" / "repro_torch"
    assert Linter(select=rules).lint_paths([str(src)]) == []
    files = {str(src / p): (src / p).read_text() for p in (
        "runtime/steps.py", "models/transformer.py", "models/blocks.py",
        "models/layers.py", "models/mla.py", "models/mamba2.py")}
    layers = str(src / "models/layers.py")
    marker = "    start = torch.clamp(pos.long(), min=0, max=max_len - seq)"
    assert files[layers].count(marker) == 1
    files[layers] = files[layers].replace(
        marker, "    start = torch.clamp(pos.long(), min=0, "
                "max=max_len - seq) + 0 * pos.item()")
    found = Linter(select=rules).lint_sources(files)
    assert any("cache_rows" in f.message and ".item()" in f.message
               for f in found), found

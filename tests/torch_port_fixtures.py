"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

The port (``src/repro_torch``) keeps its own copy of every config class, so
a JAX ``ArchConfig`` is mirrored field for field with ``port_arch``.
Reference params are built under ``jax.threefry_partitionable(False)`` —
the RNG the serving goldens were frozen with — and handed to the port as
numpy leaves through ``repro_torch.convert``.

llama-vision's tanh gates (a ``cross_attn`` block's ``attn.gate`` and
``mlp_gate``) start at 0, which makes the block the identity and hides
any fault in it; ``open_gates=True`` sets them to ``GATE``.  The goldens
were frozen with them shut.  ``frontend`` makes a batch of frame or
patch embeddings with numpy from a seed.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from repro.configs.base import ArchConfig, Segment, SSMSpec
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import base as tbase

# qwen3-shaped tiny config: qk-norm, rope theta 1e6, GQA, explicit
# head_dim, and a vocab that is not a multiple of 256 (padded to 512, so
# greedy argmax must cut the padding columns)
QWEN_TINY = ArchConfig(name="qwen3-tiny", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                       d_ff=128, vocab=300, qk_norm=True,
                       rope_theta=1_000_000.0,
                       pattern=(Segment(("attn",), 2),), dtype="float32",
                       param_dtype="float32")

# pure mamba2 with two B/C groups (4 heads read each group) and a chunk of
# 4, so prompts and prefill chunks span several scan chunks
SSM_G2_TINY = ArchConfig(name="tiny-ssm-g2", family="ssm", n_layers=2,
                         d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                         vocab=256,
                         ssm=SSMSpec(d_state=16, head_dim=16, n_groups=2,
                                     chunk=4),
                         pattern=(Segment(("mamba2",), 2),),
                         dtype="float32", param_dtype="float32")

# gemma-shaped tiny config: GeGLU, tied embeddings, and heads x head_dim
# (4 x 32 = 128) wider than d_model (64), as gemma-7b's 16 x 256 > 3072
GEMMA_TINY = ArchConfig(name="gemma-tiny", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
                        d_ff=128, vocab=300, act="geglu",
                        tie_embeddings=True,
                        pattern=(Segment(("attn",), 2),), dtype="float32",
                        param_dtype="float32")

# minitron-shaped tiny config: GQA at ratio 3 (6 query heads over 2 KV
# heads), as minitron-4b's 24 over 8
GQA3_TINY = ArchConfig(name="gqa3-tiny", family="dense", n_layers=2,
                       d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
                       d_ff=128, vocab=300,
                       pattern=(Segment(("attn",), 2),), dtype="float32",
                       param_dtype="float32")

_JAX_PARAMS: dict[tuple, dict] = {}
_TORCH_PARAMS: dict[tuple, dict] = {}
GATE = 0.5          # the opened gates' value (tanh(0.5) = 0.46)


def port_arch(arch: ArchConfig) -> tbase.ArchConfig:
    """The port's ArchConfig with every field of a JAX ArchConfig."""
    kw = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)}
    kw["pattern"] = tuple(tbase.Segment(s.blocks, s.repeat)
                          for s in arch.pattern)
    for name, cls in (("moe", tbase.MoESpec), ("ssm", tbase.SSMSpec),
                      ("mla", tbase.MLASpec), ("encoder", tbase.EncoderSpec)):
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return tbase.ArchConfig(**kw)


def opened(params: dict, arch, value: float = GATE) -> dict:
    """A copy of the param tree ``params`` (JAX or numpy leaves) in which
    every ``cross_attn`` block's ``attn.gate`` and ``mlp_gate`` are
    ``value``; the other leaves are shared."""
    out = dict(params)
    out["segments"] = [dict(seg) for seg in params["segments"]]
    for si, seg in enumerate(arch.pattern):
        for bi, kind in enumerate(seg.blocks):
            if kind == "cross_attn":
                blk = dict(out["segments"][si][f"b{bi}"])
                blk["attn"] = dict(blk["attn"])
                blk["attn"]["gate"] = np.full_like(
                    np.asarray(blk["attn"]["gate"]), value)
                blk["mlp_gate"] = np.full_like(np.asarray(blk["mlp_gate"]),
                                               value)
                out["segments"][si][f"b{bi}"] = blk
    return out


def jax_params(arch: ArchConfig, open_gates: bool = False) -> dict:
    """Reference params from PRNGKey(0) under the goldens' RNG (with
    ``open_gates``, the cross_attn gates at ``GATE``)."""
    key = (arch.name, open_gates)
    if key not in _JAX_PARAMS:
        if open_gates:
            _JAX_PARAMS[key] = jax.tree.map(
                jax.numpy.asarray, opened(jax_params(arch), arch))
        else:
            with jax.threefry_partitionable(False):
                _JAX_PARAMS[key] = JT.init_lm(jax.random.PRNGKey(0), arch)
    return _JAX_PARAMS[key]


def torch_params(arch: ArchConfig, open_gates: bool = False) -> dict:
    """``jax_params(arch, open_gates)`` converted leaf for leaf to CPU
    tensors."""
    key = (arch.name, open_gates)
    if key not in _TORCH_PARAMS:
        _TORCH_PARAMS[key] = convert.to_torch(
            jax.tree.map(np.asarray, jax_params(arch, open_gates)))
    return _TORCH_PARAMS[key]


def frontend(arch: ArchConfig, batch: int, seed: int) -> np.ndarray:
    """(batch, T, d_model) float32 N(0, 1) embeddings for ``arch``'s
    frontend: T frames of its encoder, or its n_img_tokens patches."""
    T = arch.encoder.seq_len if arch.encoder else arch.n_img_tokens
    return np.random.default_rng(seed).standard_normal(
        (batch, T, arch.d_model)).astype(np.float32)

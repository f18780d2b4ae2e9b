"""Logical component graph — ASA step 1 (Algorithm 1, line 4); copy of
``repro/core/components.py``.

A component is a (segment, block-kind) group: the unit to which the scheduler
assigns a parallelism strategy.  Param counts are *exact*: the port's own
``init_lm`` runs on the ``meta`` device (shapes and dtypes, no allocation),
where the reference runs ``jax.eval_shape`` over its initializer; the two
initializers give the same tree of shapes.  FLOPs/activation/comm metadata
are analytical, calibrated against measured times by the profiler.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import math

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, ShapeSpec

BF16 = 2  # bytes


@dataclasses.dataclass
class Component:
    name: str                  # e.g. "seg0/b1:attn.mixer", "embed", "head"
    kind: str                  # block kind | embed | head | encoder | mtp
    count: int                 # applications per forward pass
    params: float              # parameter count PER APPLICATION
    shared_params: bool        # params shared across applications (zamba2)
    flops_fwd: float           # FLOPs per application per step (whole batch)
    act_bytes: float           # output activation bytes per application
    n_model_allreduce: int     # model-axis activation all-reduces per app fwd
    moe_a2a_bytes: float = 0.0   # all-to-all bytes per app fwd (MoE dispatch+combine)
    kv_bytes: float = 0.0        # decode/prefill cache bytes per application
    path: tuple = ()             # param-tree path prefix for sharding rules
    keys: Optional[tuple] = None  # sub-component: block-dict keys it owns

    @property
    def total_params(self) -> float:
        return self.params if self.shared_params else self.params * self.count

    @property
    def total_flops_fwd(self) -> float:
        return self.flops_fwd * self.count


# block kinds split into separately-schedulable mixer/ffn sub-components
# (paper Fig. 6 granularity: attention vs MLP vs embedding)
SPLIT_KEYS = {
    "attn":      ({"norm1", "attn"}, {"norm2", "mlp"}),
    "enc_attn":  ({"norm1", "attn"}, {"norm2", "mlp"}),
    "moe_attn":  ({"norm1", "attn"}, {"norm2", "moe"}),
    "mla":       ({"norm1", "attn"}, {"norm2", "moe"}),
    "mla_dense": ({"norm1", "attn"}, {"norm2", "mlp"}),
    "cross_attn": ({"norm1", "attn"}, {"norm2", "mlp", "mlp_gate"}),
    "wdec":      ({"norm1", "attn", "norm2", "xattn"}, {"norm3", "mlp"}),
}


def _tree_size(params) -> int:
    return sum(math.prod(leaf.shape) if leaf.shape else 1
               for leaf in tree.leaves(params))


@functools.lru_cache(maxsize=64)
def abstract_params(arch: ArchConfig):
    """Exact parameter shapes without allocating anything: the port's
    ``init_lm`` on the ``meta`` device (a CPU generator: its draws are
    no-ops on meta tensors)."""
    from repro_torch.models import transformer as T
    return T.init_lm(arch, device="meta", generator=torch.Generator())


def param_count(arch: ArchConfig) -> int:
    return _tree_size(abstract_params(arch))


def active_param_count(arch: ArchConfig) -> int:
    """Active params per token (MoE: routed top_k of n_experts + always-on)."""
    total = 0
    for c in build_components(arch, seq_len=1, batch=1, mode="train"):
        p = c.total_params
        if arch.moe and c.keys and "moe" in c.keys:
            m = arch.moe
            expert_p = 3 * arch.d_model * m.d_ff      # per expert (gated mlp)
            p -= c.count * expert_p * (m.n_experts - m.top_k)
        total += p
    return int(total)


# ---------------------------------------------------------------------------
# per-kind analytics
# ---------------------------------------------------------------------------

def _attn_flops(arch: ArchConfig, B, S, T_eff, d_model=None, n_heads=None):
    nh = n_heads or arch.n_heads
    D = d_model or arch.d_model
    hd = arch.resolved_head_dim if d_model is None else D // nh
    nkv = min(arch.n_kv_heads, nh) if d_model is None else nh
    qd, kvd = nh * hd, nkv * hd
    proj = 2 * B * S * D * (qd + 2 * kvd) + 2 * B * S * qd * D
    attn = 4 * B * S * T_eff * qd
    return proj + attn


def _mlp_flops(D, F, B, S, gated=True):
    return 2 * B * S * D * F * (3 if gated else 2)


def _moe_flops(arch: ArchConfig, B, S):
    m = arch.moe
    D = arch.d_model
    f = 2 * B * S * D * m.n_experts                      # router
    f += _mlp_flops(D, m.d_ff, B, S) * m.top_k           # routed experts
    if m.n_shared_experts:
        f += _mlp_flops(D, m.shared_d_ff or m.d_ff, B, S)
    if m.dense_d_ff:
        f += _mlp_flops(D, m.dense_d_ff, B, S)
    return f


def _moe_flops_capacity(arch: ArchConfig, B, S):
    """FLOPs the capacity-based dispatch (models/moe.py) actually executes:
    every expert computes its full capacity ``C = cf*K*S/E`` of token rows
    (padded or not), plus the dispatch/combine einsums — this is what the
    lowered IR's cost analysis counts, unlike the analytic top-k routing
    of :func:`_moe_flops` which undercounts by ~capacity_factor."""
    m = arch.moe
    D = arch.d_model
    E, K = m.n_experts, m.top_k
    C = max(1, int(m.capacity_factor * K * S / E))
    f = 2 * B * S * D * E                                # router
    f += _mlp_flops(D, m.d_ff, B, E * C)                 # E experts x C rows
    f += 2 * 2 * B * S * E * C * D                       # dispatch + combine
    if m.n_shared_experts:
        f += _mlp_flops(D, m.shared_d_ff or m.d_ff, B, S)
    if m.dense_d_ff:
        f += _mlp_flops(D, m.dense_d_ff, B, S)
    return f


def _mamba_flops(arch: ArchConfig, B, S, decode=False):
    s = arch.ssm
    D = arch.d_model
    d_in = s.expand * D
    H = d_in // s.head_dim
    P, G, N = s.head_dim, s.n_groups, s.d_state
    gn = G * N
    proj = 2 * B * S * D * (2 * d_in + 2 * gn + H) + 2 * B * S * d_in * D
    conv = 2 * B * S * s.d_conv * (d_in + 2 * gn)
    if decode:
        ssd = 4 * B * S * H * P * N                       # state update + readout
    else:
        Q = min(s.chunk, S)
        ssd = 2 * B * S * Q * (gn + H * P) + 4 * B * S * H * P * N
    return proj + conv + ssd


def _mla_flops(arch: ArchConfig, B, S, T_eff):
    m, D, H = arch.mla, arch.d_model, arch.n_heads
    f = 2 * B * S * D * m.q_lora_rank
    f += 2 * B * S * m.q_lora_rank * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    f += 2 * B * S * D * (m.kv_lora_rank + m.qk_rope_head_dim)
    f += 2 * B * S * H * m.qk_nope_head_dim * m.kv_lora_rank        # q absorb
    f += 2 * B * S * T_eff * H * (m.kv_lora_rank + m.qk_rope_head_dim)  # scores
    f += 2 * B * S * T_eff * H * m.kv_lora_rank                      # ctx gather
    f += 2 * B * S * H * m.kv_lora_rank * m.v_head_dim               # v up-proj
    f += 2 * B * S * H * m.v_head_dim * D                            # out proj
    return f


def _kv_bytes(arch: ArchConfig, kind: str, B, max_len) -> float:
    if kind in ("attn", "moe_attn"):
        return 2 * B * max_len * min(arch.n_kv_heads, arch.n_heads) * \
            arch.resolved_head_dim * BF16
    if kind in ("mla", "mla_dense"):
        return B * max_len * (arch.mla.kv_lora_rank + arch.mla.qk_rope_head_dim) * BF16
    if kind == "mamba2":
        s = arch.ssm
        d_in = s.expand * arch.d_model
        H = d_in // s.head_dim
        return B * (H * s.head_dim * s.d_state + (s.d_conv - 1) *
                    (d_in + 2 * s.n_groups * s.d_state)) * 4
    if kind == "cross_attn":
        return 2 * B * arch.n_img_tokens * min(arch.n_kv_heads, arch.n_heads) * \
            arch.resolved_head_dim * BF16
    if kind == "wdec":
        enc_len = arch.encoder.seq_len if arch.encoder else 1500
        per_hd = min(arch.n_kv_heads, arch.n_heads) * arch.resolved_head_dim
        return 2 * B * (max_len + enc_len) * per_hd * BF16
    if kind == "shared_attn":
        d2 = 2 * arch.d_model
        return 2 * B * max_len * d2 * BF16
    return 0.0


# how many model-axis activation all-reduces one application incurs (fwd)
N_ALLREDUCE = {"attn": 2, "enc_attn": 2, "moe_attn": 1, "mla": 1, "mla_dense": 2,
               "mamba2": 1, "cross_attn": 2, "wdec": 3, "shared_attn": 3,
               "embed": 1, "head": 0, "mtp": 2}


def build_components(arch: ArchConfig, *, seq_len: int, batch: int,
                     mode: str = "train", attn_span: Optional[int] = None,
                     moe_capacity: bool = False) -> list[Component]:
    """mode: train | prefill | decode.  For decode, S=1 and attention spans
    the full ``seq_len`` cache.

    ``attn_span`` overrides the effective attention span T_eff: the paged
    serving steps score every query against the *full padded block table*
    (``max_blocks_per_seq * block_size`` key positions, masked), not the
    causal-average span — pass that capacity here when modelling a jitted
    paged step.  Setting it also marks the build as a serving *step* view:
    the encoder component is zeroed (it runs once at slot admission, never
    inside prefill/decode).  ``moe_capacity`` switches MoE FLOPs to the
    capacity-based dispatch actually executed (see _moe_flops_capacity).
    """
    aparams = abstract_params(arch)
    B = batch
    S = 1 if mode == "decode" else seq_len
    if attn_span is not None:
        T_eff = attn_span
    else:
        T_eff = seq_len if mode == "decode" else (seq_len + 1) / 2
    moe_fn = _moe_flops_capacity if moe_capacity else _moe_flops
    D = arch.d_model
    act = B * S * D * BF16
    comps: list[Component] = []

    gated = arch.act in ("silu", "geglu")

    def kind_flops(kind):
        """-> (mixer_flops, ffn_flops) per application."""
        if kind == "enc_attn":
            enc_len = arch.encoder.seq_len if arch.encoder else S
            return (_attn_flops(arch, B, enc_len, enc_len / 2),
                    _mlp_flops(D, arch.encoder.d_ff if arch.encoder
                               else arch.d_ff, B, enc_len, gated=gated))
        if kind == "attn":
            return (_attn_flops(arch, B, S, T_eff),
                    _mlp_flops(D, arch.d_ff, B, S, gated=gated))
        if kind == "moe_attn":
            return (_attn_flops(arch, B, S, T_eff), moe_fn(arch, B, S))
        if kind == "mla":
            return (_mla_flops(arch, B, S, T_eff), moe_fn(arch, B, S))
        if kind == "mla_dense":
            return (_mla_flops(arch, B, S, T_eff),
                    _mlp_flops(D, arch.d_ff, B, S, gated=gated))
        if kind == "mamba2":
            return (_mamba_flops(arch, B, S, decode=(mode == "decode")), 0.0)
        if kind == "cross_attn":
            return (_attn_flops(arch, B, S, arch.n_img_tokens),
                    _mlp_flops(D, arch.d_ff, B, S, gated=gated))
        if kind == "wdec":
            enc_len = arch.encoder.seq_len
            return (_attn_flops(arch, B, S, T_eff)
                    + _attn_flops(arch, B, S, enc_len),
                    _mlp_flops(D, arch.d_ff, B, S, gated=False))
        if kind == "shared_attn":
            d2 = 2 * D
            f = _attn_flops(arch, B, S, T_eff, d_model=d2, n_heads=arch.n_heads)
            f += _mlp_flops(d2, arch.d_ff, B, S, gated=gated)
            f += 2 * B * S * d2 * D                      # app_proj
            return (f, 0.0)
        raise ValueError(kind)

    # embedding
    comps.append(Component(
        name="embed", kind="embed", count=1,
        params=_tree_size(aparams["embed"]), shared_params=False,
        flops_fwd=2 * B * S * D,      # gather+scale (cheap)
        act_bytes=act, n_model_allreduce=N_ALLREDUCE["embed"], path=("embed",)))

    # encoder (whisper) — one component for the whole encoder stack
    if arch.encoder is not None:
        enc_params = _tree_size(aparams["encoder"])
        comps.append(Component(
            name="encoder", kind="enc_attn", count=arch.encoder.n_layers,
            params=enc_params / arch.encoder.n_layers, shared_params=False,
            flops_fwd=(0.0 if mode == "decode" or attn_span is not None
                       else sum(kind_flops("enc_attn"))),
            act_bytes=B * arch.encoder.seq_len * D * BF16,
            n_model_allreduce=2, path=("encoder",)))

    # zamba2 shared block params (applications are counted in the segments)
    shared_params_count = (_tree_size(aparams["shared"])
                           if "shared" in aparams else 0)

    for si, seg in enumerate(arch.pattern):
        for bi, kind in enumerate(seg.blocks):
            sub = aparams["segments"][si][f"b{bi}"]
            path = ("segments", si, f"b{bi}")
            f_mixer, f_ffn = kind_flops(kind)
            if kind in SPLIT_KEYS:
                mixer_keys, ffn_keys = SPLIT_KEYS[kind]
                p_mixer = sum(_tree_size(sub[k]) for k in mixer_keys
                              if k in sub) / seg.repeat
                p_ffn = sum(_tree_size(sub[k]) for k in ffn_keys
                            if k in sub) / seg.repeat
                comps.append(Component(
                    name=f"seg{si}/b{bi}:{kind}.mixer", kind=kind,
                    count=seg.repeat, params=p_mixer, shared_params=False,
                    flops_fwd=f_mixer, act_bytes=act,
                    n_model_allreduce=(2 if kind == "wdec" else 1),
                    kv_bytes=_kv_bytes(arch, kind, B, seq_len),
                    path=path, keys=tuple(sorted(mixer_keys))))
                comps.append(Component(
                    name=f"seg{si}/b{bi}:{kind}.ffn", kind=kind,
                    count=seg.repeat, params=p_ffn, shared_params=False,
                    flops_fwd=f_ffn, act_bytes=act, n_model_allreduce=1,
                    moe_a2a_bytes=(2 * act * arch.moe.top_k
                                   if kind in ("moe_attn", "mla") and arch.moe
                                   else 0.0),
                    path=path, keys=tuple(sorted(ffn_keys))))
            else:
                per_app = _tree_size(sub) / seg.repeat
                if kind == "shared_attn":
                    per_app = per_app + shared_params_count / seg.repeat
                comps.append(Component(
                    name=f"seg{si}/b{bi}:{kind}", kind=kind, count=seg.repeat,
                    params=per_app, shared_params=False,
                    flops_fwd=f_mixer + f_ffn, act_bytes=act,
                    n_model_allreduce=N_ALLREDUCE[kind],
                    kv_bytes=_kv_bytes(arch, kind, B, seq_len),
                    path=path))

    # head
    head_params = (0 if arch.tie_embeddings else _tree_size(aparams.get("head", {})))
    comps.append(Component(
        name="head", kind="head", count=1,
        params=head_params, shared_params=False,
        flops_fwd=2 * B * S * D * arch.padded_vocab,
        act_bytes=B * S * arch.padded_vocab * 4,
        n_model_allreduce=N_ALLREDUCE["head"], path=("head",)))

    if arch.mtp and mode == "train":
        comps.append(Component(
            name="mtp", kind="mtp", count=1,
            params=_tree_size(aparams["mtp"]), shared_params=False,
            flops_fwd=sum(kind_flops("attn")) + 2 * B * S * (2 * D) * D,
            act_bytes=act, n_model_allreduce=2, path=("mtp",)))
    return comps


def components_for_shape(arch: ArchConfig, shape: ShapeSpec) -> list[Component]:
    return build_components(arch, seq_len=shape.seq_len,
                            batch=shape.global_batch, mode=shape.kind)

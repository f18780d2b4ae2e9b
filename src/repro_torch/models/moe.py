"""Mixture-of-Experts layer, GShard capacity dispatch (twin of
``repro/models/moe.py``).

Routing variants:
  * softmax then top-k (Arctic)                        — ``router="softmax"``
  * sigmoid then top-k, renormalised over the k (DSv3) — ``router="sigmoid"``
Optional: shared expert(s) always active (DeepSeek-V3), a dense residual
FFN in parallel with the MoE branch (Arctic).

The router runs in fp32 (its weight is an fp32 leaf whatever the model's
dtype).  Each batch row is one group: token s's k-th choice takes slot
``c`` of its expert's buffer, where ``c`` counts the assignments to that
expert before it in token-major, then rank order over the row; slots at
or past the capacity ``C = int(capacity_factor * K * S / E)`` are
dropped, and a dropped assignment adds nothing (the residual stream
carries the token).  Dispatch, the expert products and combine are dense
``einsum`` / ``bmm`` over every expert's full (E, C) buffer, as the
reference computes them outside any kernel; a decode step therefore reads
every expert's weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = dict


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden dim
    n_experts: int
    top_k: int
    router: str = "softmax"    # or "sigmoid"
    capacity_factor: float = 1.25
    n_shared_experts: int = 0  # always-active shared experts (DSv3: 1)
    shared_d_ff: int = 0       # hidden dim of the shared expert branch
    dense_d_ff: int = 0        # parallel dense residual FFN (Arctic)
    act: str = "silu"
    aux_loss_weight: float = 0.01


def _estack(shape, dtype, stddev, generator, device, repeat):
    """Expert-stacked weights (E, a, b), one expert at a time, so that the
    fp32 draw never holds more than one expert's matrix."""
    lead = () if repeat is None else (repeat,)
    w = torch.empty(lead + shape, dtype=dtype, device=device)
    for idx in (range(shape[0]) if repeat is None else
                ((r, e) for r in range(repeat) for e in range(shape[0]))):
        w[idx] = L._normal(shape[1:], dtype, stddev, generator, device)
    return w


def init_moe(cfg: MoEConfig, *, generator, device, dtype=torch.float32,
             repeat: Optional[int] = None) -> Params:
    """The reference's leaves and shapes: ``router.w`` (D, E) in fp32,
    ``w_in`` / ``w_gate`` (E, D, F) and ``w_out`` (E, F, D) in ``dtype``,
    ``shared`` and ``dense`` MLPs where configured."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    kw = dict(generator=generator, device=device, repeat=repeat)
    p = {"router": L.init_dense(D, E, dtype=torch.float32, scale=s_in, **kw),
         "w_in": _estack((E, D, Fd), dtype, s_in, **kw),
         "w_gate": _estack((E, D, Fd), dtype, s_in, **kw),
         "w_out": _estack((E, Fd, D), dtype, s_out, **kw)}
    if cfg.n_shared_experts:
        d_ff = cfg.shared_d_ff or Fd * cfg.n_shared_experts
        p["shared"] = L.init_mlp(D, d_ff, act=cfg.act, dtype=dtype, **kw)
    if cfg.dense_d_ff:
        p["dense"] = L.init_mlp(D, cfg.dense_d_ff, act=cfg.act, dtype=dtype,
                                **kw)
    return p


def _act(h: torch.Tensor, g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(g) * h
    if act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    raise ValueError(act)


def route(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """-> (probs (B,S,E) fp32, gate values (B,S,K) fp32, expert ids
    (B,S,K)): the router's scores in fp32, softmax or sigmoid, the top k in
    descending order, the gates divided by their sum + 1e-9."""
    scores = torch.einsum("bsd,de->bse", x.float(), p["router"]["w"].float())
    probs = (torch.softmax(scores, dim=-1) if cfg.router == "softmax"
             else torch.sigmoid(scores))
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-9)
    return probs, gate, idx


def moe(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux loss, a 0-d fp32 tensor)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * K * S / E))   # per-row capacity
    probs, gate, idx = route(p, cfg, x)

    # slot of each (token, k) in its expert's buffer: cumsum over the
    # flattened (S*K) axis, token-major then rank
    onehot = F.one_hot(idx, E)                                   # (B,S,K,E)
    pos = torch.cumsum(onehot.reshape(B, S * K, E), dim=1).reshape(
        B, S, K, E) - 1
    keep = (pos < C) & (onehot > 0)
    # a dropped (or unchosen) assignment has an all-zero row over C
    pos_oh = (keep[..., None] & (pos[..., None] == torch.arange(
        C, device=x.device))).to(x.dtype)                        # (B,S,K,E,C)
    disp = pos_oh.sum(dim=2)                                     # (B,S,E,C)
    comb = (gate.to(x.dtype)[..., None, None] * pos_oh).sum(dim=2)

    # expert-major buffers: (E, B*C, D), one bmm per product
    xe = torch.einsum("bsd,bsec->ebcd", x, disp).reshape(E, B * C, D)
    h = torch.bmm(xe, p["w_in"].to(x.dtype))
    g = torch.bmm(xe, p["w_gate"].to(x.dtype))
    ye = torch.bmm(_act(h, g, cfg.act), p["w_out"].to(x.dtype))
    out = torch.einsum("ebcd,bsec->bsd", ye.reshape(E, B, C, D), comb)

    if cfg.n_shared_experts:
        out = out + L.mlp(p["shared"], x, cfg.act)
    if cfg.dense_d_ff:
        out = out + L.mlp(p["dense"], x, cfg.act)

    # Switch-style load balance: E * sum_e f_e * p_e / K; the routed
    # fraction f_e carries no gradient, so it reaches the router via p_e
    me = torch.mean(onehot.float().sum(dim=2), dim=(0, 1))
    pe = torch.mean(probs, dim=(0, 1))
    aux = cfg.aux_loss_weight * E * torch.sum(me * pe / K)
    return out, aux

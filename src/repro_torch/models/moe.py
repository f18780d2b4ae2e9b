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

Expert parallelism (``routed`` with an ``ExpertSplit``): every `model`
rank routes all of its tokens over all E experts, so the slots and the
drops are the whole layer's, then runs and combines only its own range of
experts; the output is that range's share, summed over the ranks by the
caller (``runtime/sharded.py``, which runs the ``SIDE_MLPS`` by d_ff).
Under a batch split over ranks (``batch_split``) the aux loss is the
whole batch's.
"""
from __future__ import annotations

import contextlib
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


@dataclasses.dataclass(frozen=True)
class ExpertSplit:
    """The experts over the ``size`` ranks of a `model` group, in order:
    rank ``rank`` holds experts rank * E / size onward (the expert stacks'
    `model` shards)."""
    size: int
    rank: int


def _estack(shape, dtype, stddev, generator, device, repeat):
    """Expert-stacked weights (E, a, b), one expert at a time, so that the
    fp32 draw never holds more than one expert's matrix."""
    lead = () if repeat is None else (repeat,)
    w = torch.empty(lead + shape, dtype=dtype, device=device)
    for idx in (range(shape[0]) if repeat is None else
                ((r, e) for r in range(repeat) for e in range(shape[0]))):
        w[idx] = L._normal(shape[1:], dtype, stddev, generator, device)
    return w


# the MLPs beside the experts, each on every token: DeepSeek-V3's shared
# expert(s) and Arctic's dense residual FFN
SIDE_MLPS = ("shared", "dense")


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


class _BatchMean(torch.autograd.Function):
    """The mean over the ``n`` ranks of ``group`` (an all-reduce / n);
    backward: the gradient as it is.  Every rank takes the same gradient
    of the mean, and the train step's reduction of the weights' gradients
    divides by the world, so dividing here too would count each rank's
    term 1 / n times too little."""

    @staticmethod
    def forward(ctx, x, group, n):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# (group, n): the ranks whose batch rows differ, while ``batch_split`` runs
_batch = None


@contextlib.contextmanager
def batch_split(group, n: int):
    """Within it (the forward and the backward, whose checkpointed layers
    run their forward again), the aux loss's means ``me`` and ``pe`` run
    over the rows of the ``n`` ranks of ``group`` that split the batch,
    as the reference's run over the global batch; its product is then the
    whole batch's on every rank."""
    global _batch
    old, _batch = _batch, (group, n)
    try:
        yield
    finally:
        _batch = old


def routed(p: Params, cfg: MoEConfig, x: torch.Tensor,
           split: Optional[ExpertSplit] = None):
    """x: (B, S, D) -> (the routed experts' output (B, S, D), aux loss):
    the layer without its ``SIDE_MLPS``.

    With ``split`` the expert stacks of ``p`` are this rank's (E / size
    experts) and the output is their share (the caller sums the shares
    over the ranks).  The aux loss keeps its value, but its gradient is
    scaled by 1 / size: every rank computes it whole from the same
    tokens, so a router (and an input) whose gradient is summed over the
    ranks would count it ``size`` times."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * K * S / E))   # per-row capacity
    probs, gate, idx = route(p, cfg, x)

    # slot of each (token, k) in its expert's buffer: cumsum over the
    # flattened (S*K) axis, token-major then rank
    # F.one_hot would check idx's range with two host reads on the CPU
    onehot = (idx[..., None] == torch.arange(E, device=idx.device)).long()
    pos = torch.cumsum(onehot.reshape(B, S * K, E), dim=1).reshape(
        B, S, K, E) - 1
    keep = (pos < C) & (onehot > 0)
    # a dropped (or unchosen) assignment has an all-zero row over C
    pos_oh = (keep[..., None] & (pos[..., None] == torch.arange(
        C, device=x.device))).to(x.dtype)                        # (B,S,K,E,C)
    if split is not None:               # this rank's experts' slots only
        n = E // split.size
        pos_oh = pos_oh[:, :, :, split.rank * n:(split.rank + 1) * n]
    disp = pos_oh.sum(dim=2)                                     # (B,S,E,C)
    comb = (gate.to(x.dtype)[..., None, None] * pos_oh).sum(dim=2)

    # expert-major buffers: (E, B*C, D), one bmm per product
    El = disp.shape[2]
    xe = torch.einsum("bsd,bsec->ebcd", x, disp).reshape(El, B * C, D)
    h = torch.bmm(xe, p["w_in"].to(x.dtype))
    g = torch.bmm(xe, p["w_gate"].to(x.dtype))
    ye = torch.bmm(_act(h, g, cfg.act), p["w_out"].to(x.dtype))
    out = torch.einsum("ebcd,bsec->bsd", ye.reshape(El, B, C, D), comb)

    # Switch-style load balance: E * sum_e f_e * p_e / K; the routed
    # fraction f_e carries no gradient, so it reaches the router via p_e
    me = torch.mean(onehot.float().sum(dim=2), dim=(0, 1))
    pe = torch.mean(probs, dim=(0, 1))
    if _batch is not None:
        me, pe = _BatchMean.apply(torch.stack([me, pe]), *_batch)
    aux = cfg.aux_loss_weight * E * torch.sum(me * pe / K)
    if split is not None:
        # the aux-loss trap: its forward value stays (the difference term
        # is exactly 0), its backward is 1 / size of it on each rank
        aux = aux.detach() + (aux - aux.detach()) / split.size
    return out, aux


def moe(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux loss, a 0-d fp32 tensor): the
    routed experts (``routed``) plus the MLPs beside them (``SIDE_MLPS``)."""
    out, aux = routed(p, cfg, x)
    for key in SIDE_MLPS:
        if key in p:
            out = out + L.mlp(p[key], x, cfg.act)
    return out, aux

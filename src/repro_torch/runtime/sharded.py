"""The sharded train step's pieces, behind ``steps.make_train_step(
act_sharding=, grad_shardings=)``: each rank's slice of the batch, the
weights gathered on use, Megatron's f and g around the tensor-parallel
blocks, each gradient reduced to its parameter's placement, and the
global norm over shards.  A placed serving engine
(``serving/placement.py``) runs the same gathers and the same
tensor-parallel blocks, their paged and slot-state paths, without
gradients.

Params and optimizer moments are DTensors placed by the plan's specs
(``core/sharding.py``).  The forward and backward run on plain local
tensors: the kernels are autograd Functions over ctypes-bound CUDA code
that DTensor dispatch never reaches.  Every leaf plays one of four roles:

  * ``full`` — gathered whole on use (all-gathered over every mesh dim it
    is sharded on), so each rank computes the whole gradient of its own
    batch rows; the reduction to the leaf's placement sums over every
    rank (reduce-scatter where the leaf is sharded, all-reduce where it is
    replicated) and divides by the world size: a rank that shares its
    rows with others (the `model` axis of MP and HP) adds the same
    gradient as they do, so the mean over ranks is the mean over rows;
  * ``local`` — a tensor-parallel weight under MP / HP, sharded over
    `model` by the plan's specs: an attention's wq, wk, wv by columns and
    wo by rows, an MLP's w_in, w_gate by columns and w_out by rows, a
    mamba2 mixer's z/x/dt_proj by columns, out_proj by rows and conv_x,
    A_log, D and its gated norm's scale by heads, zamba2's app_proj by
    rows, MLA's wq_a, wq_b, wk_b, wv_b by columns (head-major but wq_a's)
    and wo by rows, the MoE expert stacks by experts, the MTP head's proj
    by columns: gathered over every mesh dim but `model`, whose shard the
    rank keeps and computes with (its own heads, its d_ff slice, its
    experts); its gradient is that shard's, summed over the other dims
    and divided by their size;
  * ``partial`` — a weight used whole inside the tensor-parallel region
    whose gradient each `model` rank holds only in part: the q/k norms'
    scales (each rank normalises its own heads), wk / wv where the KV
    heads do not divide over `model` (the reference keeps them
    replicated; each rank picks the KV heads of its Q heads), a
    mamba2 mixer's b/c_proj, conv_b/c and dt_bias (replicated; each rank
    computes B and C whole and reads them, and its slice of dt_bias, for
    its own heads), MLA's q_norm, wkv_a and kv_norm (the latents computed
    whole, read by each rank's heads) and the MoE router (every rank
    routes every token; the gates reach it through each rank's own
    experts, and the aux loss, computed whole on every rank, through a
    gradient scaled by 1 / size: ``moe.routed``); summed over every rank,
    `model` included, and divided by the non-`model` size;
  * ``expert`` — an expert stack of the EP-major layout (``core.sharding.
    MOE_EP_AXIS = "data"``: experts over `data`, the expert FF dim over
    `model`): kept as it lies on both, and computed with there.  The
    all-to-all's backward brings every `data` rank's rows' gradient to
    the experts' owner, so the shard's gradient is already summed over
    `data` (and is its F slice's whole over `model`): it is summed over
    the other dims only (`pod`, where the stacks are replicated) and
    divided by the batch's shards (data x pod), which makes it the
    single rank's.

Repeat-stacked leaves are gathered one application at a time, as the
model reaches it (``_Stacked``), others at the start of the forward.  The
reductions run in each gather's backward, so the gradients reach their
placements microbatch by microbatch.  Every collective runs in the same
order on every rank: the forward's gathers in the model's order, the
backward's reductions in autograd's, which is the same graph everywhere.

Tensor-parallel blocks (``plan_layout``): ``attn``, the encoder's
``enc_attn`` and ``moe_attn`` (``tp_attn_block``), ``mla`` and
``mla_dense`` (``tp_mla_block``: the latent attention by heads, the q
latent all-gathered before q_norm, the latents and their pools whole on
every rank), whisper's ``wdec`` (self and cross attention, MLP),
llama-vision's ``cross_attn`` (its tanh gates after the all-reduce),
zamba2's ``shared_attn`` (the shared weights walked once, used by every
application; app_proj by rows), ``mamba2`` (its heads, the gated norm
over the whole d_inner through the split-row RMSNorm) and the MTP head
(``tp_mtp_head``: proj by columns, then its columns all-gathered, and its
``attn`` block).  The MoE FFN is expert-parallel (``_moe``).  Where the
plan lays the expert stacks over `model` (``MOE_EP_AXIS = "model"``), the
`model` ranks hold the same tokens, so each routes them all and computes
its own experts, the shared and dense MLPs by d_ff beside them, and one
all-reduce sums the parts.  Under the EP-major layout (``MOE_EP_AXIS =
"data"``) each rank routes its own rows, one all-to-all over `data` sends
each expert's slots to its owner and one brings the outputs back
(``moe.ExpertAllToAll``), each rank computes with its `model` slice of
the expert FF dim, and the same one all-reduce over `model` after
combine sums the slices' parts.  A batch not split over `data` (the
placed engine's: every rank holds the same rows) needs no all-to-all:
each rank runs its `data` range of experts on every row, and one
all-reduce over the world sums the parts.  FS lays the batch over
`model` too: there every weight is gathered on use, the expert stacks
included (the cost model gives FS no EP term either).  zamba2's shared
leaves are used at every application, and their gradients sum over the
applications as any leaf's do.

The serving steps run the same blocks on three paths: the
whole-sequence forward, the paged step on the engine's pools, and the
contiguous decode cache (``transformer.init_cache``) at the plan's
``cache_specs`` placement, written in place at its ``pos``.  Those specs
lay the attention caches' time axis over `model` (``TPBlock.cache_time``):
a block all-gathers that axis around its attention, the rank writes its
own heads' new rows, the ranks exchange them (``_fill_heads``) so that
every head's are there, and the rank keeps its own time slice.  MLA's
latents are computed whole on every rank and written whole; mamba2's
``conv_x`` and ``ssm`` lie by heads, as its mixer runs.

What this does not do: re-gather in the backward (a gathered weight lives
from its use in the forward to its gradient, as the plain step's do).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import sharding as SH
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE

ROLES = ("full", "local", "partial", "expert")


def _dt():
    from torch.distributed import tensor as dtensor
    return dtensor


# ---------------------------------------------------------------------------
# gather on use, reduce in the backward
# ---------------------------------------------------------------------------

def _all_gather(x, dim: int, n: int, group, f: int = 1):
    """The shards ``x`` of the ``n`` ranks of ``group`` along ``dim``,
    concatenated in rank order: gathered rank-major as ``x`` lies, then
    laid out along ``dim`` by one copy (none where ``dim`` is 0).  With a
    split factor ``f`` (a ``_StridedShard``'s), ``x`` is ``f`` pieces, one
    of each of the ``f`` parts of the whole, and each part gets its ``n``
    pieces in rank order."""
    x = x.contiguous()
    dim %= x.ndim
    buf = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    parts = list(x.shape)
    parts[dim:dim + 1] = [f, x.shape[dim] // f]
    return buf.view([n] + parts).movedim(0, dim + 1).reshape(shape)


def _gather_dims(t, mesh, have, want):
    """``t``, this rank's shard under placements ``have``, all-gathered
    by ``torch.distributed``'s own collective over every mesh dim of more
    than one rank that ``have`` shards and ``want`` replicates, the
    innermost first: the inverse of ``sharding.shard_of``, so two mesh
    dims that shard one tensor dim concatenate in the order the
    placements say (a ``_StridedShard`` puts the spec's order on them).
    A tensor dim that ``want`` keeps sharded must not be gathered over
    another mesh dim (that is a re-layout, not a gather; no param spec
    asks it).

    Every gather on use, ``gather_full`` and so every whole-tensor read
    (the int8 moments' update, checkpoints, ``Trainer.resize``) take it,
    on every backend: DTensor's redistribute to Replicate runs the
    functional all-gather, which faults (SIGSEGV, torch 2.11) on a gloo
    group over CUDA tensors."""
    D = _dt()
    kept = {SH.shard_dim(p)[0] for p in want if SH.shard_dim(p)}
    if any(SH.shard_dim(p) and isinstance(w, D.Replicate)
           and SH.shard_dim(p)[0] in kept for p, w in zip(have, want)):
        raise ValueError(f"{have} -> {want} is not a gather")
    for i in reversed(range(len(have))):
        s, n = SH.shard_dim(have[i]), mesh.shape[i]
        if n == 1 or s is None or not isinstance(want[i], D.Replicate):
            continue
        t = _all_gather(t, s[0], n, mesh.get_group(i), s[1])
    return t


class _Gather(torch.autograd.Function):
    """local shard (placements ``have``) -> the working tensor (placements
    ``want``: Replicate, or the `model` shard kept); backward: the
    working tensor's gradient, partial over every dim ``want``
    replicates, reduced to ``have`` and scaled by ``scale``."""

    @staticmethod
    def forward(ctx, local, mesh, have, want, scale):
        ctx.mesh, ctx.have, ctx.want, ctx.scale = mesh, have, want, scale
        out = _gather_dims(local.detach(), mesh, have, want)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        D = _dt()
        partial = tuple(D.Partial() if isinstance(w, D.Replicate) else w
                        for w in ctx.want)
        # DTensor reduces to the mesh's order: the spec's blocks go there
        # first (nothing moves unless a _StridedShard lays them out)
        g, have = SH.to_mesh_order(g.contiguous(), ctx.mesh, ctx.have)
        out = D.DTensor.from_local(g, ctx.mesh, partial, run_check=False) \
            .redistribute(ctx.mesh, have).to_local()
        if ctx.scale != 1.0:
            out = out * ctx.scale
        return out, None, None, None, None


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """How one param leaf is stored and used: its placements on the mesh,
    its role (``ROLES``) and whether it is repeat-stacked."""
    placements: tuple
    role: str
    stacked: bool


def _shift(placements):
    """A stacked leaf's placements for one application (dim 0 dropped;
    it is never sharded)."""
    return tuple(SH.with_dim(p, SH.shard_dim(p)[0] - 1) if SH.shard_dim(p)
                 else p for p in placements)


class _Working:
    """Makes the working tensors of one leaf: its ``want`` placements and
    gradient scale from its layout and the mesh."""

    def __init__(self, layout: LeafLayout, mesh, model_dim: Optional[int]):
        D = _dt()
        self.mesh = mesh
        have = layout.placements
        if layout.stacked:
            have = _shift(have)
        self.have = have
        names = tuple(mesh.mesh_dim_names)
        kept = ({model_dim} if layout.role == "local" else
                {i for i, n in enumerate(names) if n in ("data", "model")}
                if layout.role == "expert" else set())
        self.want = tuple(p if i in kept else D.Replicate()
                          for i, p in enumerate(have))
        world = mesh.size()
        model = mesh.shape[model_dim] if model_dim is not None else 1
        self.scale = (1.0 / world if layout.role == "full"
                      else model / world)

    def __call__(self, local):
        return _Gather.apply(local, self.mesh, self.have, self.want,
                             self.scale)


class _Stacked:
    """A repeat-stacked leaf seen by the model: ``[r]`` gathers
    application r's weights (``transformer._take`` indexes it)."""

    def __init__(self, local, make: _Working):
        self.local, self.make = local, make

    def __getitem__(self, r):
        return self.make(self.local[r])


# ---------------------------------------------------------------------------
# Megatron's f and g
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient over `model`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """g: all-reduce over `model` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The last dim's shards all-gathered over `model` in rank order (each
    rank's columns of a column-parallel projection); backward: this
    rank's columns of the gradient, summed over `model` first where
    ``reduce`` (each rank holds a part of it: a reduce-scatter, as an
    all-reduce and a slice) or taken as they are (every rank holds the
    same whole gradient: no communication)."""

    @staticmethod
    def forward(ctx, x, tp, reduce):
        ctx.tp, ctx.reduce, ctx.cols = tp, reduce, x.shape[-1]
        return _all_gather(x, -1, tp.size, tp.group)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.reduce:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=tp.group)
        return g.narrow(-1, tp.rank * ctx.cols,
                        ctx.cols).contiguous(), None, None


# ---------------------------------------------------------------------------
# the tensor-parallel blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPBlock:
    """One block's tensor parallelism over the `model` group of ``size``
    ranks (this one ``rank``): which of its parts compute on this rank's
    share.  ``attn``: its attention (self, encoder, zamba2's shared block's
    or llama-vision's cross attention) by heads, ``kv_heads`` the KV heads
    this rank picks from replicated wk / wv (None where they are sharded
    too); ``xattn`` / ``xkv_heads``: whisper's decoder cross attention the
    same way; ``mlp``: the MLP by d_ff; ``mixer``: mamba2's mixer by heads;
    ``app_proj``: zamba2's per-application projection by rows; ``mla``:
    the latent attention by heads, ``q_split`` where wq_a is split by
    columns too (the q latent all-gathered); ``experts``: the MoE experts
    by ranges over `model` (``moe.ExpertSplit``), or by the EP-major
    layout's ``ep`` (an ``moe.ExpertAllToAll`` over `data`, or an
    ``ExpertSplit`` over `data` where every rank holds the same rows),
    its parts summed over ``ep_group`` (the world in the latter case;
    else `model`), ``ep_lead`` the ranks of it that add the side MLP's
    parts (one `data` rank's, where the sum runs over the world);
    ``side_mlp`` the MLP beside them (``moe.SIDE_MLPS``: DeepSeek's shared
    expert, Arctic's dense FFN) by d_ff; ``proj``: the MTP head's
    projection by columns; ``cache_time``: the block's contiguous
    attention caches lie split over `model` along time (the plan's
    ``cache_specs``)."""
    group: object
    size: int
    rank: int
    attn: bool
    kv_heads: Optional[tuple]
    mlp: bool = False
    xattn: bool = False
    xkv_heads: Optional[tuple] = None
    mixer: bool = False
    app_proj: bool = False
    mla: bool = False
    q_split: bool = False
    experts: bool = False
    side_mlp: bool = False
    proj: bool = False
    ep: Optional[object] = None
    ep_group: Optional[object] = None
    ep_lead: bool = True
    cache_time: bool = False

    @property
    def on(self) -> bool:
        """Whether any part of the block runs on this rank's share."""
        return (self.attn or self.xattn or self.mlp or self.mixer or
                self.app_proj or self.mla or self.experts or self.side_mlp
                or self.proj)


def _pick_heads(p: dict, heads: tuple, head_dim: int) -> dict:
    idx = list(heads)
    w = p["w"]
    out = {"w": w.reshape(w.shape[0], -1, head_dim)[:, idx].reshape(
        w.shape[0], -1)}
    if "b" in p:
        out["b"] = p["b"].reshape(-1, head_dim)[idx].reshape(-1)
    return out


def _row_parallel(fn, p_out: dict, x, tp: TPBlock):
    """g(fn with the row-parallel projection's bias held back) + bias:
    the bias is added once, after the all-reduce."""
    y = _ReduceFromTP.apply(fn({"w": p_out["w"]}, x), tp.group)
    return y + p_out["b"].to(y.dtype) if "b" in p_out else y


def _kv_view(cache: dict, heads: tuple):
    """The KV ``cache`` ({"k", "v"}: a paged pool (NB, BS, Hkv, D),
    cross-K/V rows (B, T, Hkv, D), or a contiguous cache's rows, whose
    ``pos`` passes through) at ``heads`` -> (view, write_back): a
    view where the heads are a contiguous range (the attention writes a
    pool through it), else a copy that ``write_back()`` puts back.

    Where ``cache`` is the local tensor of a replicated pool, each `model`
    rank writes only its own heads into it, so the ranks' copies differ on
    the heads they do not own although the pool's DTensor says Replicate.
    Such a pool must be read only through the paged step, never whole
    (``full_tensor``, a redistribute, a checkpoint or a sanitizer read
    would see one rank's partial copy)."""
    lo = heads[0]
    rows = {k: t for k, t in cache.items() if k != "pos"}
    pos = {k: t for k, t in cache.items() if k == "pos"}
    if heads == tuple(range(lo, lo + len(heads))):
        return {**{k: t.narrow(2, lo, len(heads))
                   for k, t in rows.items()}, **pos}, lambda: None
    idx = torch.as_tensor(heads, device=cache["k"].device)
    part = {k: t.index_select(2, idx) for k, t in rows.items()}

    def write_back():
        for k, t in rows.items():
            t.index_copy_(2, idx, part[k])
    return {**part, **pos}, write_back


def _tp_attention(a: dict, cfg, h, tp: TPBlock, kv_heads, *, cache=None,
                  kv_input=None, **kw):
    """The attention ``a`` (``cfg``) over ``h`` on this rank's Q heads and
    the KV heads they read -> y, all-reduced over `model`, wo's bias added
    once after it and then llama-vision's tanh gate (a ``full`` leaf, as
    the bias: every rank applies it to the same sum).  ``cache``: a paged
    pool or cross-K/V rows, this rank's shard (its KV heads) or whole, of
    which it reads and writes only those heads (``_kv_view``);
    ``kv_input``: cross attention's replicated K/V input, through f as
    ``h`` is (each rank's K/V projections give its gradient a share)."""
    a = dict(a)
    n_kv = cfg.n_kv_heads // tp.size
    heads = tuple(range(tp.rank * n_kv, (tp.rank + 1) * n_kv))
    if kv_heads is not None:
        a["wk"] = _pick_heads(a["wk"], kv_heads, cfg.head_dim)
        a["wv"] = _pick_heads(a["wv"], kv_heads, cfg.head_dim)
        heads, n_kv = kv_heads, len(kv_heads)
    # a cache sharded by KV heads holds exactly this rank's; a whole one
    # (always so where the KV heads do not divide) is viewed at them
    write_back = None
    if cache is not None and (kv_heads is not None
                              or cache["k"].shape[2] != n_kv):
        cache, write_back = _kv_view(cache, heads)
    lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size,
                               n_kv_heads=n_kv, gated=False)
    wo, gate = a.pop("wo"), a.pop("gate", None)
    if kv_input is not None:
        kv_input = _CopyToTP.apply(kv_input, tp.group)

    def attend(o, hin):
        return L.attention({**a, "wo": o}, lcfg, hin, cache=cache,
                           kv_input=kv_input, **kw)[0]
    y = _row_parallel(attend, wo, _CopyToTP.apply(h, tp.group), tp)
    if write_back is not None:
        write_back()
    if cfg.gated:
        y = torch.tanh(gate.to(y.dtype)) * y
    return y


def _attention(a: dict, cfg, h, tp: TPBlock, on: bool, kv_heads, **kw):
    """An attention, tensor-parallel by ``tp`` where ``on``, else whole."""
    if on:
        return _tp_attention(a, cfg, h, tp, kv_heads, **kw)
    return L.attention(a, cfg, h, **kw)[0]


def _mlp_part(m: dict, hin, act: str):
    """The MLP ``m`` by d_ff (w_in, w_gate by columns, w_out by rows) on
    ``hin`` (after f), before g -> (this rank's share of the output,
    w_out's bias or None: it is added once, after g)."""
    w_out = m["w_out"]
    y = L.mlp({**m, "w_out": {"w": w_out["w"]}}, hin, act)
    return y, w_out.get("b")


def _mlp(m: dict, h, act: str, tp: TPBlock, on: bool):
    """The MLP by d_ff where ``on``, else whole."""
    if not on:
        return L.mlp(m, h, act)
    y, bias = _mlp_part(m, _CopyToTP.apply(h, tp.group), act)
    y = _ReduceFromTP.apply(y, tp.group)
    return y if bias is None else y + bias.to(y.dtype)


def _moe(m: dict, arch: ArchConfig, h, tp: TPBlock):
    """The MoE FFN ``m`` over ``h`` -> (y, aux): ``moe.moe``'s routed
    experts plus its side MLPs, the experts by ranges where
    ``tp.experts`` (over `model`: each rank routes every token over every
    expert and combines its own range's outputs; EP-major, ``tp.ep``:
    over `data`, by all-to-all where the rows differ, each rank with its
    `model` slice of the FF dim), the side MLP by d_ff where
    ``tp.side_mlp``; the parts on this rank's share added and
    all-reduced once over ``tp.ep_group`` or `model` (f before, g after),
    the biases and the parts computed whole added after."""
    cfg = B.moe_cfg_for(arch)
    if not (tp.experts or tp.side_mlp):
        return MOE.moe(m, cfg, h)
    group = tp.ep_group or tp.group
    if group is not tp.group and torch.is_grad_enabled() and \
            h.requires_grad:
        raise ValueError("the EP-major layout trains with the batch split "
                         "over `data` (its all-to-all); a batch every rank "
                         "holds whole is served, not trained")
    hin = _CopyToTP.apply(h, group)
    split = tp.ep or (MOE.ExpertSplit(tp.size, tp.rank) if tp.experts
                      else None)
    y, aux = MOE.routed(m, cfg, hin if tp.experts else h, split)
    parts, whole = ([y], []) if tp.experts else ([], [y])
    for key in MOE.SIDE_MLPS:
        if key not in m:
            continue
        if tp.side_mlp:
            part, bias = _mlp_part(m[key], hin, cfg.act)
            parts += [part] if tp.ep_lead else []
            whole += [] if bias is None else [bias.to(part.dtype)]
        else:
            whole.append(L.mlp(m[key], h, cfg.act))
    y = _ReduceFromTP.apply(sum(parts), group)
    for w in whole:
        y = y + w
    return y, aux


def _cache_path(cache, block_tables) -> str:
    """A block call's path: ``"whole"`` (the whole-sequence forward),
    ``"paged"`` (a serving step on the engine's pools) or
    ``"contiguous"`` (a decode cache, ``transformer.init_cache``)."""
    if block_tables is not None:
        if cache is None:
            raise ValueError("the paged step needs the block's pools")
        return "paged"
    return "whole" if cache is None else "contiguous"


def _time_whole(cache: dict, tp: TPBlock) -> dict:
    """A contiguous cache whose rows (B, T / size, ...) are this rank's
    `model` shard along time, all-gathered whole (every row, in rank
    order); ``pos`` is the cache's own tensor."""
    return {k: t if k == "pos" else _all_gather(t, 1, tp.size, tp.group)
            for k, t in cache.items()}


def _time_back(cache: dict, whole: dict, tp: TPBlock) -> None:
    """This rank's time slice of each row leaf of ``whole`` written back
    into its shard ``cache``."""
    for k, t in cache.items():
        if k != "pos":
            t.copy_(whole[k].narrow(1, tp.rank * t.shape[1], t.shape[1]))


def _fill_heads(cache: dict, rows, cfg, tp: TPBlock, kv_heads) -> None:
    """Every KV head's new ``rows`` of the whole contiguous cache
    ``cache``, where this rank wrote only its own heads' (those of its Q
    heads: ``kv_heads``, or its range of them): each rank's heads
    all-gathered over `model`, and each head taken from the first rank
    that owns it."""
    n_kv = cfg.n_kv_heads
    picks = [L.local_groups(cfg.n_heads, n_kv, tp.size, r)
             if kv_heads is not None else
             tuple(range(r * n_kv // tp.size, (r + 1) * n_kv // tp.size))
             for r in range(tp.size)]
    n = len(picks[tp.rank])
    if any(len(p) != n for p in picks):
        raise ValueError(f"the ranks own {[len(p) for p in picks]} KV heads: "
                         f"their new rows do not gather evenly")
    src = [next(r * n + j for r in range(tp.size)
                for j, hd in enumerate(picks[r]) if hd == head)
           for head in range(n_kv)]
    dev = cache["k"].device
    own = torch.as_tensor(picks[tp.rank], device=dev)
    src = torch.as_tensor(src, device=dev)
    for key in ("k", "v"):
        t = cache[key]
        new = t.index_select(1, rows).index_select(2, own)
        every = _all_gather(new, 2, tp.size, tp.group)
        t.index_copy_(1, rows, every.index_select(2, src))


def _self_attention(a: dict, cfg, h, tp: TPBlock, on: bool, kv_heads, *,
                    cache, **kw):
    """A self-attention (``_attention``) on any path.  On the contiguous
    path with ``tp.cache_time`` the cache's time shards are gathered
    around it, the new rows of every head made whole on every rank where
    each rank wrote its own heads (``_fill_heads``), and this rank's time
    slice written back."""
    if cache is None or "block_tables" in kw and \
            kw["block_tables"] is not None or not tp.cache_time:
        return _attention(a, cfg, h, tp, on, kv_heads, cache=cache, **kw)
    whole = _time_whole(cache, tp)
    rows = L.cache_rows(cache["pos"], h.shape[1], whole["k"].shape[1])
    y = _attention(a, cfg, h, tp, on, kv_heads, cache=whole, **kw)
    if on:
        _fill_heads(whole, rows, cfg, tp, kv_heads)
    _time_back(cache, whole, tp)
    return y


def _mla(a: dict, arch: ArchConfig, h, tp: TPBlock, *, positions, cache,
         block_tables, new_lens):
    """The latent attention ``a`` over ``h``: the whole-sequence forward,
    the paged step on the latent pools ``cache`` (replicated: every rank
    writes the same latents into its own copy, which stays whole), or the
    contiguous latent cache ``cache`` at its ``pos`` (whole on every
    rank, or split over `model` along time, ``tp.cache_time``: gathered
    around the call, this rank's slice written back).
    Where ``tp.mla``, on this rank's heads (a config of H / size heads,
    the q latent all-gathered before ``q_norm`` where wq_a is split),
    all-reduced after wo, whose bias is added once; else whole."""
    cfg = B.mla_cfg_for(arch)
    path = _cache_path(cache, block_tables)
    kw = (dict(positions=positions) if path == "whole" else
          dict(cache=cache) if path == "contiguous" else
          dict(cache=cache, positions=positions, block_tables=block_tables,
               new_lens=new_lens))
    fn = (MLA.mla_paged_attention if path == "paged"
          else MLA.mla_attention)
    whole = None
    if path == "contiguous" and tp.cache_time:
        whole = kw["cache"] = _time_whole(cache, tp)
    if not tp.mla:
        y = fn(a, cfg, h, **kw)[0]
    else:
        lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size)
        gather = ((lambda q: _GatherFromTP.apply(q, tp, True))
                  if tp.q_split else None)
        a = dict(a)
        wo = a.pop("wo")
        y = _row_parallel(
            lambda o, hin: fn({**a, "wo": o}, lcfg, hin, gather_q=gather,
                              **kw)[0],
            wo, _CopyToTP.apply(h, tp.group), tp)
    if whole is not None:           # every rank wrote the same latents
        _time_back(cache, whole, tp)
    return y


def _cross_kw(cross_input, rows, slot_ids) -> dict:
    """A cross attention's K/V source: the slot rows of each batch row on
    the serving path (``slot_ids``); else ``cross_input``, written into a
    contiguous cache's cross rows ``rows`` where it has them, or those
    rows read where ``cross_input`` is None (with neither, the attention
    runs over its own input, as ``blocks._cross``)."""
    if slot_ids is not None:
        sid = slot_ids.long()
        return {"cache": {"k": rows["k"][sid], "v": rows["v"][sid]}}
    return {"kv_input": cross_input, "cache": rows}


def tp_attn_block(tp: TPBlock):
    """-> a function with ``blocks.apply_block``'s signature that applies
    a dense ``attn``, an encoder ``enc_attn`` or a ``moe_attn`` block
    tensor-parallel by ``tp`` (the MoE FFN as ``_moe``): the
    whole-sequence forward, a paged serving step (``cache`` and
    ``block_tables``), or a step on a contiguous cache (``cache`` alone).
    On the paged path the rank attends with its own Q heads over the KV
    heads they read, which it writes into ``cache`` in place: ``cache`` is
    this rank's shard of a pool sharded by KV heads over `model` (the
    plan's paged-cache specs under MP / HP), or a whole pool (replicated:
    the KV heads do not divide, or the weights alone are sharded), of
    which the rank reads and writes only those heads (``_kv_view`` says
    what that asks of the pool's readers).  The contiguous cache lies as
    the plan's ``cache_specs`` lay it (``_self_attention``)."""
    def apply(p, kind, arch: ArchConfig, x, *, positions=None, impl="xla",
              cache=None, block_tables=None, new_lens=None, **_):
        if kind not in ("attn", "enc_attn", "moe_attn"):
            raise ValueError(f"tp_attn_block applies attn, enc_attn and "
                             f"moe_attn blocks, not {kind!r}")
        _cache_path(cache, block_tables)
        enc = kind == "enc_attn"
        cfg = B.attn_cfg_for(arch, causal=not enc, use_rope=not enc)
        x = x + _self_attention(
            p["attn"], cfg, B.norm_apply(arch, p["norm1"], x), tp, tp.attn,
            tp.kv_heads, positions=positions, impl=impl, cache=cache,
            block_tables=block_tables, new_lens=new_lens)
        h = B.norm_apply(arch, p["norm2"], x)
        if kind == "moe_attn":
            y, aux = _moe(p["moe"], arch, h, tp)
            return x + y, cache, aux
        return x + _mlp(p["mlp"], h, arch.act, tp, tp.mlp), cache, 0.0
    apply.own_pools = tp.attn
    return apply


def tp_mla_block(tp: TPBlock):
    """-> an ``mla_dense`` (latent attention, MLP) or ``mla`` (latent
    attention, MoE) block tensor-parallel by ``tp``: the attention by
    heads (``_mla``), the MLP by d_ff, the MoE as ``_moe``; the
    whole-sequence forward, a paged step on the block's latent pools,
    which the plan replicates and every rank keeps whole (so nothing is
    gathered around the block: it owns its pools), or a step on its
    contiguous latent cache."""
    def apply(p, kind, arch: ArchConfig, x, *, positions=None, cache=None,
              block_tables=None, new_lens=None, **_):
        if kind not in B.MLA_KINDS:
            raise ValueError(f"tp_mla_block applies mla and mla_dense "
                             f"blocks, not {kind!r}")
        x = x + _mla(p["attn"], arch, B.norm_apply(arch, p["norm1"], x), tp,
                     positions=positions, cache=cache,
                     block_tables=block_tables, new_lens=new_lens)
        h = B.norm_apply(arch, p["norm2"], x)
        if kind == "mla":
            y, aux = _moe(p["moe"], arch, h, tp)
            return x + y, cache, aux
        return x + _mlp(p["mlp"], h, arch.act, tp, tp.mlp), cache, 0.0
    apply.own_pools = True
    return apply


def tp_mtp_head(tp: TPBlock, block=None):
    """-> ``transformer.mtp_logits``' head function: the projection of the
    concatenation ``z`` by columns where ``tp.proj`` (f before it, then
    the columns all-gathered; the gather's backward is this rank's columns
    of the gradient, which every rank holds whole), then the ``attn``
    block through ``block`` (``tp_attn_block``'s, or whole)."""
    def apply(mtp, arch: ArchConfig, z, positions):
        if tp.proj:
            h = _GatherFromTP.apply(L.dense(mtp["proj"], _CopyToTP.apply(
                z, tp.group)), tp, False)
        else:
            h = L.dense(mtp["proj"], z)
        return (block or B.apply_block)(mtp["block"], "attn", arch, h,
                                        positions=positions)[0]
    return apply


def tp_wdec_block(tp: TPBlock):
    """-> whisper's decoder block (``wdec``) tensor-parallel by ``tp``:
    its causal self-attention as ``tp_attn_block``'s (its pool or
    contiguous cache ``cache["self"]``), its cross attention by heads over
    the encoder output or this rank's slot rows (``cache["cross"]``, its
    KV heads; a contiguous cache's cross rows: written from the encoder
    output where it is given, else read), its MLP by d_ff."""
    def apply(p, kind, arch: ArchConfig, x, *, positions=None, impl="xla",
              cache=None, block_tables=None, new_lens=None, slot_ids=None,
              cross_input=None, **_):
        if kind != "wdec":
            raise ValueError(f"tp_wdec_block applies wdec blocks, not "
                             f"{kind!r}")
        _cache_path(cache, block_tables)
        x = x + _self_attention(
            p["attn"], B.attn_cfg_for(arch, use_rope=False),
            B.norm_apply(arch, p["norm1"], x), tp, tp.attn, tp.kv_heads,
            positions=positions, impl=impl,
            cache=None if cache is None else cache["self"],
            block_tables=block_tables, new_lens=new_lens)
        x = x + _attention(p["xattn"], B.cross_cfg_for(arch, kind),
                           B.norm_apply(arch, p["norm2"], x), tp, tp.xattn,
                           tp.xkv_heads, impl=impl, **_cross_kw(
                               cross_input,
                               None if cache is None else cache["cross"],
                               slot_ids))
        return x + _mlp(p["mlp"], B.norm_apply(arch, p["norm3"], x),
                        arch.act, tp, tp.mlp), cache, 0.0
    apply.own_pools = tp.attn and tp.xattn
    return apply


def tp_cross_block(tp: TPBlock):
    """-> llama-vision's gated cross-attention block (``cross_attn``)
    tensor-parallel by ``tp``: the attention by heads over the frontend,
    this rank's slot rows or a contiguous cache's cross rows (its KV
    heads; written from the frontend where it is given, else read), its
    tanh gate after the all-reduce; the MLP by d_ff, scaled by
    tanh(mlp_gate) after it."""
    def apply(p, kind, arch: ArchConfig, x, *, impl="xla", cache=None,
              slot_ids=None, cross_input=None, **_):
        if kind != "cross_attn":
            raise ValueError(f"tp_cross_block applies cross_attn blocks, "
                             f"not {kind!r}")
        x = x + _attention(p["attn"], B.cross_cfg_for(arch, kind),
                           B.norm_apply(arch, p["norm1"], x), tp, tp.attn,
                           tp.kv_heads, impl=impl,
                           **_cross_kw(cross_input, cache, slot_ids))
        h = _mlp(p["mlp"], B.norm_apply(arch, p["norm2"], x), arch.act, tp,
                 tp.mlp)
        return x + torch.tanh(p["mlp_gate"].to(h.dtype)) * h, cache, 0.0
    apply.own_pools = tp.attn
    return apply


def tp_shared_block(tp: TPBlock):
    """-> one application of zamba2's shared block (``shared_attn``)
    tensor-parallel by ``tp``: the shared attention (2 x d_model, every
    head its own KV head) by heads over this application's paged pool
    (its shard) or contiguous cache, the shared MLP by d_ff, then
    ``app_proj`` by rows: the
    rank takes its columns of the replicated concat, after f, and g
    follows.  The shared weights are ``shared``, used by every
    application; autograd sums their gradients over the applications."""
    def apply(p, kind, arch: ArchConfig, x, *, x0=None, shared=None,
              positions=None, impl="xla", cache=None, block_tables=None,
              new_lens=None, **_):
        if kind != "shared_attn" or shared is None or x0 is None:
            raise ValueError("tp_shared_block applies shared_attn blocks, "
                             "with the shared params and the embeddings")
        _cache_path(cache, block_tables)
        z = torch.cat([x, x0], dim=-1)
        z = z + _self_attention(
            shared["attn"], B.shared_cfg_for(arch),
            B.norm_apply(arch, shared["norm1"], z), tp, tp.attn, tp.kv_heads,
            positions=positions, impl=impl, cache=cache,
            block_tables=block_tables, new_lens=new_lens)
        z = z + _mlp(shared["mlp"], B.norm_apply(arch, shared["norm2"], z),
                     arch.act, tp, tp.mlp)
        if tp.app_proj:
            cols = z.shape[-1] // tp.size
            zl = _CopyToTP.apply(z, tp.group)[
                ..., tp.rank * cols:(tp.rank + 1) * cols]
            y = _row_parallel(L.dense, p["app_proj"], zl, tp)
        else:
            y = L.dense(p["app_proj"], z)
        return x + y, cache, 0.0
    apply.own_pools = tp.attn
    return apply


def tp_mamba2_block(tp: TPBlock):
    """-> a ``mamba2`` block tensor-parallel by ``tp``: the outer norm
    whole, then the mixer on this rank's heads (``mamba2.mamba2`` with a
    ``HeadSplit``: its projections' columns, conv_x channels, A_log, D,
    gated-norm columns, and its shard of the conv_x and ssm slot pools or
    contiguous caches, conv_b and conv_c whole), f before it and g after
    out_proj, whose bias is added once."""
    split = M2.HeadSplit(tp.group, tp.size, tp.rank)

    def apply(p, kind, arch: ArchConfig, x, *, cache=None, slot_ids=None,
              new_lens=None, impl="xla", **_):
        if kind != "mamba2":
            raise ValueError(f"tp_mamba2_block applies mamba2 blocks, not "
                             f"{kind!r}")
        mixer = dict(p["mixer"])
        out = mixer.pop("out_proj")

        def run(o, h):
            y, _ = B.mamba2_mixer({**mixer, "out_proj": o}, arch, h,
                                  cache=cache, slot_ids=slot_ids,
                                  new_lens=new_lens, impl=impl, split=split)
            return y
        y = _row_parallel(run, out, _CopyToTP.apply(
            B.norm_apply(arch, p["norm"], x), tp.group), tp)
        return x + y, cache, 0.0
    apply.own_pools = True
    return apply


def gather_full(local, mesh, placements: tuple):
    """The whole tensor of which ``local`` is this rank's shard under
    ``placements`` (all-gathered over every sharding mesh dim of more than
    one rank); ``local`` itself where there is none."""
    D = _dt()
    if not any(SH.shard_dim(pl) and mesh.shape[i] > 1
               for i, pl in enumerate(placements)):
        return local
    return _gather_dims(local, mesh, placements,
                        (D.Replicate(),) * len(placements))


def whole(x):
    """The whole tensor of the DTensor ``x`` (``gather_full`` of its
    local shard on its own mesh), read where DTensor's ``full_tensor()``
    would be: that one faults on a gloo group over CUDA tensors."""
    return gather_full(x.to_local(), x.device_mesh, x.placements)


# ---------------------------------------------------------------------------
# layouts: each leaf's role, each block's tensor parallelism
# ---------------------------------------------------------------------------

def _axis_at(spec, dim: int):
    ax = spec[dim] if -len(spec) <= dim < len(spec) else None
    if isinstance(ax, tuple) and "model" in ax:
        raise ValueError(f"spec {spec!r}: `model` shares a dim with another "
                         f"axis in a tensor-parallel weight")
    return ax


def _attn_layout(a: dict, pre: str, n_heads: int, n_kv: int, size: int,
                 rank: int):
    """-> (kv_heads, roles) of an attention whose wq the specs ``a`` shard
    by columns over `model` (``kv_heads``: those this rank picks from
    replicated wk / wv, None where they are sharded), or None where they
    do not.  Roles: wq, wo (and wk, wv when sharded) ``local``; the q/k
    norms' scales and replicated wk, wv ``partial``; wo's bias and the
    gate ``full``."""
    if _axis_at(a["wq"]["w"], -1) != "model":
        return None
    if _axis_at(a["wo"]["w"], -2) != "model":
        raise ValueError(f"{pre}: wq is column-sharded but wo is not "
                         f"row-sharded")
    kv = _axis_at(a["wk"]["w"], -1) == "model"
    roles = {}
    for mod, leaves in a.items():
        if not isinstance(leaves, dict):              # the tanh gate
            continue
        for leaf in leaves:
            if (mod, leaf) == ("wo", "b"):
                continue
            roles[f"{pre}.{mod}.{leaf}"] = (
                "partial" if mod in ("q_norm", "k_norm")
                else "local" if mod in ("wq", "wo") or kv else "partial")
    return (None if kv else L.local_groups(n_heads, n_kv, size, rank)), roles


def _mlp_layout(m: dict, pre: str):
    """-> the roles of an MLP whose w_in the specs shard by columns over
    `model` (every leaf ``local`` but w_out's bias), or None."""
    if _axis_at(m["w_in"]["w"], -1) != "model":
        return None
    if _axis_at(m["w_out"]["w"], -2) != "model":
        raise ValueError(f"{pre}: w_in is column-sharded but w_out is not "
                         f"row-sharded")
    return {f"{pre}.{mod}.{leaf}": "local" for mod, leaves in m.items()
            for leaf in leaves if (mod, leaf) != ("w_out", "b")}


# mamba2's mixer under tensor parallelism: the leaves on this rank's heads
# (out_proj's weight too; its bias is ``full``) and the replicated ones
# used whole, whose gradient each rank holds in part
_MAMBA2_LOCAL = ("z_proj", "x_proj", "dt_proj", "conv_x", "A_log", "D",
                 "norm", "out_proj")
_MAMBA2_PARTIAL = ("b_proj", "c_proj", "conv_b", "conv_c", "dt_bias")


def _mamba2_layout(mx: dict, pre: str):
    """-> the roles of a mamba2 mixer whose x_proj the specs shard by
    columns over `model`, or None."""
    if _axis_at(mx["x_proj"]["w"], -1) != "model":
        return None
    roles = {}
    for mod, leaves in mx.items():
        items = leaves.items() if isinstance(leaves, dict) else [("", leaves)]
        for leaf, spec in items:
            name = f"{pre}.{mod}" + (f".{leaf}" if leaf else "")
            if (mod, leaf) == ("out_proj", "b"):
                continue
            if mod in _MAMBA2_PARTIAL:
                roles[name] = "partial"
            elif mod in _MAMBA2_LOCAL and "model" in tuple(spec):
                roles[name] = "local"
            else:
                raise ValueError(f"{name}: spec {spec!r} under a "
                                 f"tensor-parallel mamba2 mixer")
    return roles


# MLA under tensor parallelism by heads: the head-major projections on this
# rank's heads (wo by rows; its bias is ``full``); every other leaf
# (q_norm, wkv_a, kv_norm, and wq_a where its columns are not split) is
# computed whole on every rank and its gradient held in part
_MLA_LOCAL = ("wq_b", "wk_b", "wv_b", "wo")


def _mla_layout(a: dict, pre: str, n_heads: int, size: int):
    """-> (q_split, roles) of a latent attention whose head-major
    projections the specs ``a`` split by columns over `model` at head
    boundaries (wo by rows), or None where they do not (``_sanitize``
    divides columns, not heads: H * head_dim may divide the axis where H
    does not), and the block gathers them."""
    if not (n_heads % size == 0 and
            all(_axis_at(a[m]["w"], -1) == "model"
                for m in ("wq_b", "wk_b", "wv_b")) and
            _axis_at(a["wo"]["w"], -2) == "model"):
        return None
    q_split = _axis_at(a["wq_a"]["w"], -1) == "model"
    roles = {}
    for mod, leaves in a.items():
        for leaf in leaves:
            if (mod, leaf) == ("wo", "b"):
                continue
            roles[f"{pre}.{mod}.{leaf}"] = (
                "local" if mod in _MLA_LOCAL or (mod == "wq_a" and q_split)
                else "partial")
    return q_split, roles


def _moe_layout(m: dict, pre: str):
    """-> (layout, roles) of a MoE FFN: ``layout`` "model" where the specs
    split the expert stacks over `model` by experts, with the stacks
    ``local``; "data" where they lay them out EP-major (``w_in`` /
    ``w_gate`` ``P("data", None, "model")``, ``w_out`` ``P("data",
    "model", None)``: experts over `data`, the FF dim over `model`, either
    replicated where it does not divide), with the stacks ``expert``;
    None where neither (``_sanitize`` replicates the expert dim where E
    does not divide: the stacks then run whole).  The router is
    ``partial`` under both (the routed gradient reaches it through each
    rank's own experts, or its F slice's part)."""
    ax = _axis_at(m["w_in"], -3)
    if ax not in ("model", "data"):
        return None, {}
    if any(_axis_at(m[k], -3) != ax for k in ("w_gate", "w_out")):
        raise ValueError(f"{pre}: w_in is split by experts over {ax!r} but "
                         f"w_gate or w_out is not")
    if ax == "data":
        ff = [_axis_at(m["w_in"], -1), _axis_at(m["w_gate"], -1),
              _axis_at(m["w_out"], -2)]
        if len(set(ff)) != 1 or ff[0] not in ("model", None) or any(
                _axis_at(m[k], -2 if k != "w_out" else -1) is not None
                for k in ("w_in", "w_gate", "w_out")):
            raise ValueError(f"{pre}: EP-major expert stacks with specs "
                             f"{[tuple(m[k]) for k in ('w_in', 'w_gate', 'w_out')]}")
    role = "local" if ax == "model" else "expert"
    roles = {f"{pre}.{k}": role for k in ("w_in", "w_gate", "w_out")}
    roles.update({f"{pre}.router.{leaf}": "partial" for leaf in m["router"]})
    return ax, roles


def batch_group(mesh, batch_spec):
    """-> (group, n): the process group of the ``n`` ranks over which
    ``batch_spec`` splits the rows (those of one `model` coordinate under
    DP and HP, every rank under FS), or None where each rank holds the
    whole batch."""
    ax = batch_spec[0] if len(batch_spec) else None
    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(a) for a in (
        () if ax is None else ax if isinstance(ax, tuple) else (ax,))]
    dims = [d for d in dims if mesh.shape[d] > 1]
    if not dims:
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0]), mesh.shape[dims[0]]
    if all(mesh.shape[d] == 1 for d in range(mesh.ndim) if d not in dims):
        return dist.group.WORLD, mesh.size()
    raise ValueError(f"a batch laid over {ax!r} on a mesh of "
                     f"{dict(zip(names, mesh.shape))}: its ranks are no "
                     f"single group")


def plan_layout(arch: ArchConfig, specs, mesh, batch_spec,
                cache_specs=None):
    """-> (leaf roles: {leaf name (``tree.names``): role} for the
    non-``full`` leaves,
    block_fns for ``lm_apply``: {segment: {block: fn}}, the encoder's
    under ``"encoder"`` and ``mtp_logits``' head function under
    ``"mtp"``).  ``specs``: the params' spec tree; ``batch_spec``: the
    batch's (tensor parallelism needs the `model` ranks to hold the same
    rows, so a batch laid over `model`, as FS lays it, gathers every
    weight on use); ``cache_specs``: the contiguous caches' spec tree
    (``sharding.cache_specs``) where the blocks run on such caches, which
    says whose attention caches lie split over `model` along time.

    A block runs tensor-parallel where the specs shard its weights over
    `model`: ``attn``, ``enc_attn`` and ``moe_attn``
    (``tp_attn_block``), ``mla`` and ``mla_dense`` (``tp_mla_block``),
    ``wdec``, ``cross_attn``, ``shared_attn`` and ``mamba2``; each of its
    parts (the attention, the latent attention, the cross attention, the
    MLP, the MoE experts and its shared and dense MLPs, the mixer,
    app_proj) on its own share where its own specs say so (an ASA plan may
    shard a block's mixer and not its FFN), else whole.  The MoE experts
    follow the stacks' specs: over `model`, or EP-major over `data` (by
    all-to-all where ``batch_spec`` splits the rows over `data`; else
    every rank runs its range on every row).  zamba2's shared
    weights (``specs["shared"]``) are walked once, for every application,
    and so is the MTP head (``specs["mtp"]``: its projection by columns,
    its ``attn`` block by heads and d_ff)."""
    names = tuple(mesh.mesh_dim_names)
    ax = batch_spec[0] if len(batch_spec) else None
    if "model" not in names or "model" in (
            ax if isinstance(ax, tuple) else (ax,)):
        return {}, {}
    mdim = names.index("model")
    group = mesh.get_group(mdim)
    size, rank = mesh.shape[mdim], mesh.get_local_rank(mesh_dim=mdim)
    n_kv = min(arch.n_kv_heads, arch.n_heads)
    roles = {}
    rows_over = ax if isinstance(ax, tuple) else (ax,)
    ddim = names.index("data") if "data" in names else None
    dsize = mesh.shape[ddim] if ddim is not None else 1
    drank = mesh.get_local_rank(mesh_dim=ddim) if ddim is not None else 0

    def ep_fields():
        """The TPBlock fields of EP-major experts on this mesh and batch."""
        if dsize == 1:      # every expert here: its F slice over `model`
            return dict(ep=MOE.ExpertSplit(1, 0, sharing=size))
        if "data" in rows_over:
            return dict(ep=MOE.ExpertAllToAll(mesh.get_group(ddim), dsize,
                                              drank, sharing=size))
        if mesh.size() != dsize * size:
            raise ValueError(f"EP-major experts on a mesh of "
                             f"{dict(zip(names, mesh.shape))} with a batch "
                             f"laid over {ax!r}: no single group sums them")
        return dict(ep=MOE.ExpertSplit(dsize, drank, sharing=dsize * size),
                    ep_group=dist.group.WORLD, ep_lead=drank == 0)

    def time_split(cspec) -> bool:
        """Whether a contiguous attention cache's spec (one leaf's, with
        its repeat axis) splits time (dim 2) over a `model` of > 1."""
        return size > 1 and cspec is not None and len(cspec) > 2 and \
            cspec[2] == "model"

    def attn(a, pre, n=arch.n_heads, kv=n_kv):
        got = _attn_layout(a, pre, n, kv, size, rank)
        if got is None:
            return False, None
        roles.update(got[1])
        return True, got[0]

    def mlp(m, pre):
        got = _mlp_layout(m, pre)
        roles.update(got or {})
        return got is not None

    shared = None
    if "shared" in specs:
        on, kv_heads = attn(specs["shared"]["attn"], "shared.attn",
                            arch.n_heads, arch.n_heads)
        shared = dict(attn=on, kv_heads=kv_heads,
                      mlp=mlp(specs["shared"]["mlp"], "shared.mlp"))

    def moe(m, pre):
        """-> the TPBlock fields of a MoE FFN: its side MLPs by d_ff only
        where the specs split every one of them."""
        layout, got = _moe_layout(m, pre)
        roles.update(got)
        sides = [_mlp_layout(m[k], f"{pre}.{k}") for k in MOE.SIDE_MLPS
                 if k in m]
        side = bool(sides) and None not in sides
        for r in sides if side else ():
            roles.update(r)
        return dict(experts=layout is not None, side_mlp=side,
                    **(ep_fields() if layout == "data" else {}))

    def cached(cspec, key) -> dict:
        """The TPBlock field of a block whose contiguous self-attention
        cache is ``cspec[key]`` (``cspec``: the block's cache specs)."""
        c = (cspec or {}).get(key) if key else cspec
        return dict(cache_time=time_split((c or {}).get("k")))

    def block(kind, b, pre, cspec):
        """-> this block's function, or None where it runs whole."""
        if kind in ("attn", "enc_attn", "cross_attn", "moe_attn"):
            on, kv_heads = attn(b["attn"], f"{pre}.attn")
            ffn = (moe(b["moe"], f"{pre}.moe") if kind == "moe_attn" else
                   dict(mlp=mlp(b["mlp"], f"{pre}.mlp")))
            tp = TPBlock(group, size, rank, on, kv_heads, **ffn,
                         **cached(cspec, None))
            make = tp_cross_block if kind == "cross_attn" else tp_attn_block
        elif kind in B.MLA_KINDS:
            q_split, got = _mla_layout(b["attn"], f"{pre}.attn",
                                       arch.n_heads, size) or (False, None)
            roles.update(got or {})
            ffn = (moe(b["moe"], f"{pre}.moe") if kind == "mla" else
                   dict(mlp=mlp(b["mlp"], f"{pre}.mlp")))
            tp = TPBlock(group, size, rank, False, None, **ffn,
                         mla=got is not None, q_split=q_split,
                         cache_time=time_split(
                             (cspec or {}).get("c_kv")))
            make = tp_mla_block
        elif kind == "wdec":
            on, kv_heads = attn(b["attn"], f"{pre}.attn")
            x_on, x_kv = attn(b["xattn"], f"{pre}.xattn")
            tp = TPBlock(group, size, rank, on, kv_heads,
                         mlp(b["mlp"], f"{pre}.mlp"), xattn=x_on,
                         xkv_heads=x_kv, **cached(cspec, "self"))
            make = tp_wdec_block
        elif kind == "shared_attn":
            app = _axis_at(b["app_proj"]["w"], -2) == "model"
            if app:
                roles[f"{pre}.app_proj.w"] = "local"
            tp = TPBlock(group, size, rank, **shared, app_proj=app,
                         **cached(cspec, None))
            make = tp_shared_block
        elif kind == "mamba2":
            got = _mamba2_layout(b["mixer"], f"{pre}.mixer")
            roles.update(got or {})
            tp = TPBlock(group, size, rank, False, None, False,
                         mixer=got is not None)
            make = tp_mamba2_block
        else:
            return None
        return make(tp) if tp.on else None

    fns = {}
    for si, seg in enumerate(arch.pattern):
        for bi, kind in enumerate(seg.blocks):
            fn = block(kind, specs["segments"][si][f"b{bi}"],
                       f"segments.{si}.b{bi}",
                       None if cache_specs is None
                       else cache_specs[si][f"b{bi}"])
            if fn is not None:
                fns.setdefault(si, {})[bi] = fn
    for si, seg in enumerate((specs.get("encoder") or {}).get("segments",
                                                             [])):
        fn = block("enc_attn", seg["b0"], f"encoder.segments.{si}.b0",
                   None)
        if fn is not None:
            fns.setdefault("encoder", {}).setdefault(si, {})[0] = fn
    if "mtp" in specs:
        m = specs["mtp"]
        on, kv_heads = attn(m["block"]["attn"], "mtp.block.attn")
        proj = _axis_at(m["proj"]["w"], -1) == "model"
        roles.update({f"mtp.proj.{leaf}": "local" for leaf in m["proj"]}
                     if proj else {})
        tp = TPBlock(group, size, rank, on, kv_heads,
                     mlp(m["block"]["mlp"], "mtp.block.mlp"), proj=proj)
        if tp.on:
            fns["mtp"] = tp_mtp_head(tp, tp_attn_block(tp) if (
                tp.attn or tp.mlp) else None)
    return roles, fns


def layouts(shardings, roles: dict) -> list:
    """A ``LeafLayout`` for each param leaf, in ``tree.leaves`` order;
    ``shardings``: the params' tree of ``NamedSharding``."""
    return [LeafLayout(ns.placements, roles.get(name, "full"),
                       name.startswith(("segments.", "encoder.segments.")))
            for name, ns in zip(tree.names(shardings),
                                tree.leaves(shardings))]


def working_tree(params, live: list, lays: list, mesh):
    """The tree the model runs on: each leaf's local shard ``live[i]``
    turned into its working tensor (gathered now), or for a stacked leaf
    into a ``_Stacked`` that gathers each application on use."""
    names = tuple(mesh.mesh_dim_names)
    mdim = names.index("model") if "model" in names else None
    work = []
    for x, lay in zip(live, lays):
        make = _Working(lay, mesh, mdim)
        work.append(_Stacked(x, make) if lay.stacked else make(x))
    return tree.unflatten(params, work)


def replicas(lay: LeafLayout, mesh) -> int:
    """How many ranks hold each shard of a leaf (the product of the mesh
    dims it is replicated over)."""
    D = _dt()
    n = 1
    for i, p in enumerate(lay.placements):
        if isinstance(p, D.Replicate):
            n *= mesh.shape[i]
    return n


def global_norm(grads: list, lays: list, mesh) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2) over the whole of each
    leaf, from the local shards: each rank's sums, a replicated leaf's
    divided by its replica count, all-reduced once."""
    sq = []
    for g, lay in zip(grads, lays):
        s = torch.sum(torch.square(g.float()))
        n = replicas(lay, mesh)
        sq.append(s / n if n > 1 else s)
    total = torch.sum(torch.stack(sq))
    dist.all_reduce(total)
    return torch.sqrt(total)


def local_of(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of ``full`` (the same on every rank) as the
    DTensor ``like`` is placed."""
    return SH.shard_of(full, like.device_mesh, like.placements)

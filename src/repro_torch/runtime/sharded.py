"""The sharded train step's pieces, behind ``steps.make_train_step(
act_sharding=, grad_shardings=)``: each rank's slice of the batch, the
weights gathered on use, Megatron's f and g around the tensor-parallel
dense ``attn`` block, each gradient reduced to its parameter's placement,
and the global norm over shards.  A placed serving engine
(``serving/placement.py``) runs the same gathers and the same
tensor-parallel block, its paged path, without gradients.

Params and optimizer moments are DTensors placed by the plan's specs
(``core/sharding.py``).  The forward and backward run on plain local
tensors: the kernels are autograd Functions over ctypes-bound CUDA code
that DTensor dispatch never reaches.  Every leaf plays one of three roles:

  * ``full`` — gathered whole on use (all-gathered over every mesh dim it
    is sharded on), so each rank computes the whole gradient of its own
    batch rows; the reduction to the leaf's placement sums over every
    rank (reduce-scatter where the leaf is sharded, all-reduce where it is
    replicated) and divides by the world size: a rank that shares its
    rows with others (the `model` axis of MP and HP) adds the same
    gradient as they do, so the mean over ranks is the mean over rows;
  * ``local`` — a tensor-parallel weight of the dense ``attn`` block under
    MP / HP (wq, wk, wv, w_in, w_gate by columns; wo, w_out by rows):
    gathered over every mesh dim but `model`, whose shard the rank keeps
    and computes with (its own heads and its d_ff slice); its gradient is
    that shard's, summed over the other dims and divided by their size;
  * ``partial`` — a weight used whole inside the tensor-parallel region
    whose gradient each `model` rank holds only in part: the q/k norms'
    scales (each rank normalises its own heads) and wk / wv where the KV
    heads do not divide over `model` (the reference keeps them
    replicated; each rank picks the KV heads of its Q heads); summed over
    every rank, `model` included, and divided by the non-`model` size.

Repeat-stacked leaves are gathered one application at a time, as the
model reaches it (``_Stacked``), others at the start of the forward.  The
reductions run in each gather's backward, so the gradients reach their
placements microbatch by microbatch.  Every collective runs in the same
order on every rank: the forward's gathers in the model's order, the
backward's reductions in autograd's, which is the same graph everywhere.

What this does not do yet: re-gather in the backward (a gathered weight
lives from its use in the forward to its gradient, as the plain step's
do), and tensor-parallel compute for any block kind but ``attn`` (the MLA,
MoE, mamba2, shared, cross and encoder-decoder kinds gather on use).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

ROLES = ("full", "local", "partial")


def _dt():
    from torch.distributed import tensor as dtensor
    return dtensor


# ---------------------------------------------------------------------------
# gather on use, reduce in the backward
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """local shard (placements ``have``) -> the working tensor (placements
    ``want``: Replicate, or the `model` shard kept); backward: the
    working tensor's gradient, partial over every dim ``want``
    replicates, reduced to ``have`` and scaled by ``scale``."""

    @staticmethod
    def forward(ctx, local, mesh, have, want, scale):
        ctx.mesh, ctx.have, ctx.want, ctx.scale = mesh, have, want, scale
        D = _dt()
        out = D.DTensor.from_local(local.detach(), mesh, have,
                                   run_check=False) \
            .redistribute(mesh, want).to_local()
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        D = _dt()
        partial = tuple(D.Partial() if isinstance(w, D.Replicate) else w
                        for w in ctx.want)
        out = D.DTensor.from_local(g.contiguous(), ctx.mesh, partial,
                                   run_check=False) \
            .redistribute(ctx.mesh, ctx.have).to_local()
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
    D = _dt()
    return tuple(D.Shard(p.dim - 1) if isinstance(p, D.Shard) else p
                 for p in placements)


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
        self.want = tuple(p if (layout.role == "local" and i == model_dim)
                          else D.Replicate() for i, p in enumerate(have))
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


# ---------------------------------------------------------------------------
# the tensor-parallel dense attn block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPBlock:
    """One dense ``attn`` block's tensor parallelism: over the `model`
    group of ``size`` ranks (this one ``rank``), the attention by heads
    (``attn``; ``kv_heads``: the KV heads this rank picks from replicated
    wk / wv, None where they are sharded too) and the MLP by d_ff
    (``mlp``)."""
    group: object
    size: int
    rank: int
    attn: bool
    kv_heads: Optional[tuple]
    mlp: bool


def local_kv_heads(n_heads: int, n_kv: int, size: int, rank: int) -> tuple:
    """The KV heads the Q heads of ``rank`` read (q head g reads g //
    (n_heads / n_kv)): a contiguous range when it keeps the grouping
    (each local KV head serving an equal run of local Q heads), else one
    KV head a local Q head."""
    hl, rep = n_heads // size, n_heads // n_kv
    heads = [(rank * hl + i) // rep for i in range(hl)]
    lo, count = heads[0], heads[-1] - heads[0] + 1
    if hl % count == 0 and all(h == lo + i // (hl // count)
                               for i, h in enumerate(heads)):
        return tuple(range(lo, lo + count))
    return tuple(heads)


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
    """The paged pool ``cache`` ({"k", "v": (NB, BS, Hkv, D)}) at ``heads``
    -> (view, write_back): a view where the heads are a contiguous range
    (the attention writes the pool through it), else a copy that
    ``write_back()`` puts back.

    Where ``cache`` is the local tensor of a replicated pool, each `model`
    rank writes only its own heads into it, so the ranks' copies differ on
    the heads they do not own although the pool's DTensor says Replicate.
    Such a pool must be read only through the paged step, never whole
    (``full_tensor``, a redistribute, a checkpoint or a sanitizer read
    would see one rank's partial copy)."""
    lo = heads[0]
    if heads == tuple(range(lo, lo + len(heads))):
        return {k: t.narrow(2, lo, len(heads)) for k, t in cache.items()}, \
            lambda: None
    idx = torch.as_tensor(heads, device=cache["k"].device)
    part = {k: t.index_select(2, idx) for k, t in cache.items()}

    def write_back():
        for k, t in cache.items():
            t.index_copy_(2, idx, part[k])
    return part, write_back


def tp_attn_block(tp: TPBlock):
    """-> a function with ``blocks.apply_block``'s signature that applies
    a dense ``attn`` block tensor-parallel by ``tp``: the whole-sequence
    forward, or a paged serving step (``cache`` and ``block_tables``).
    On the paged path the rank attends with its own Q heads over the KV
    heads they read, which it writes into ``cache`` in place: ``cache``
    is this rank's shard of a pool sharded by KV heads over `model` (the
    plan's paged-cache specs under MP / HP), or a whole pool (replicated:
    the KV heads do not divide, or the weights alone are sharded), of
    which the rank reads and writes only those heads (``_kv_view`` says
    what that asks of the pool's readers)."""
    def apply(p, kind, arch: ArchConfig, x, *, positions=None, impl="xla",
              cache=None, block_tables=None, new_lens=None, **_):
        if kind != "attn" or (cache is None) != (block_tables is None):
            raise ValueError("the tensor-parallel block is the dense attn "
                             "block's whole-sequence forward or paged step")
        paged = dict(cache=cache, block_tables=block_tables,
                     new_lens=new_lens)
        cfg = B.attn_cfg_for(arch)
        h = B.norm_apply(arch, p["norm1"], x)
        if tp.attn:
            a = dict(p["attn"])
            n_kv = cfg.n_kv_heads // tp.size
            heads = tuple(range(tp.rank * n_kv, (tp.rank + 1) * n_kv))
            if tp.kv_heads is not None:
                a["wk"] = _pick_heads(a["wk"], tp.kv_heads, cfg.head_dim)
                a["wv"] = _pick_heads(a["wv"], tp.kv_heads, cfg.head_dim)
                heads = tp.kv_heads
                n_kv = len(heads)
            # a pool sharded by KV heads holds exactly this rank's; a whole
            # one (always so where the KV heads do not divide) is viewed at
            # them
            write_back = None
            if cache is not None and (tp.kv_heads is not None
                                      or cache["k"].shape[2] != n_kv):
                paged["cache"], write_back = _kv_view(cache, heads)
            lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size,
                                       n_kv_heads=n_kv)
            wo = a.pop("wo")

            def attend(o, hin):
                return L.attention({**a, "wo": o}, lcfg, hin,
                                   positions=positions, impl=impl,
                                   **paged)[0]
            y = _row_parallel(attend, wo, _CopyToTP.apply(h, tp.group), tp)
            if write_back is not None:
                write_back()
        else:
            y, _ = L.attention(p["attn"], cfg, h, positions=positions,
                               impl=impl, **paged)
        x = x + y
        h = B.norm_apply(arch, p["norm2"], x)
        if tp.mlp:
            m = dict(p["mlp"])
            w_out = m.pop("w_out")
            y = _row_parallel(lambda o, hin: L.mlp({**m, "w_out": o}, hin,
                                                   arch.act),
                              w_out, _CopyToTP.apply(h, tp.group), tp)
        else:
            y = L.mlp(p["mlp"], h, arch.act)
        return x + y, cache, 0.0
    return apply


def gather_full(local, mesh, placements: tuple):
    """The whole tensor of which ``local`` is this rank's shard under
    ``placements`` (all-gathered over every sharding mesh dim of more than
    one rank); ``local`` itself where there is none."""
    D = _dt()
    if not any(isinstance(pl, D.Shard) and mesh.shape[i] > 1
               for i, pl in enumerate(placements)):
        return local
    return D.DTensor.from_local(local, mesh, placements, run_check=False) \
        .redistribute(mesh, (D.Replicate(),) * len(placements)).to_local()


# ---------------------------------------------------------------------------
# layouts: each leaf's role, each attn block's tensor parallelism
# ---------------------------------------------------------------------------

def _axis_at(spec, dim: int):
    ax = spec[dim] if -len(spec) <= dim < len(spec) else None
    if isinstance(ax, tuple) and "model" in ax:
        raise ValueError(f"spec {spec!r}: `model` shares a dim with another "
                         f"axis in a tensor-parallel weight")
    return ax


def plan_layout(arch: ArchConfig, specs, mesh, batch_spec):
    """-> (leaf roles: {leaf name (``tree.names``): role} for the
    non-``full`` leaves,
    block_fns for ``lm_apply``).  ``specs``: the params' spec tree;
    ``batch_spec``: the batch's (tensor parallelism needs the `model`
    ranks to hold the same rows, so a batch laid over `model`, as FS
    lays it, gathers every weight on use)."""
    names = tuple(mesh.mesh_dim_names)
    ax = batch_spec[0] if len(batch_spec) else None
    if "model" not in names or "model" in (
            ax if isinstance(ax, tuple) else (ax,)):
        return {}, {}
    mdim = names.index("model")
    group = mesh.get_group(mdim)
    size, rank = mesh.shape[mdim], mesh.get_local_rank(mesh_dim=mdim)
    roles, fns = {}, {}
    for si, seg in enumerate(arch.pattern):
        for bi, kind in enumerate(seg.blocks):
            if kind != "attn":
                continue
            b = specs["segments"][si][f"b{bi}"]
            pre = f"segments.{si}.b{bi}"
            attn = _axis_at(b["attn"]["wq"]["w"], -1) == "model"
            mlp = _axis_at(b["mlp"]["w_in"]["w"], -1) == "model"
            if not (attn or mlp):
                continue
            kv_heads = None
            if attn:
                if _axis_at(b["attn"]["wo"]["w"], -2) != "model":
                    raise ValueError(f"{pre}: wq is column-sharded but wo "
                                     f"is not row-sharded")
                kv = _axis_at(b["attn"]["wk"]["w"], -1) == "model"
                if not kv:
                    kv_heads = local_kv_heads(arch.n_heads, min(
                        arch.n_kv_heads, arch.n_heads), size, rank)
                for mod, leaves in b["attn"].items():
                    for leaf in leaves:
                        role = ("partial" if mod in ("q_norm", "k_norm")
                                else "full" if (mod, leaf) == ("wo", "b")
                                else "local" if mod in ("wq", "wo") or kv
                                else "partial")
                        roles[f"{pre}.attn.{mod}.{leaf}"] = role
            if mlp:
                if _axis_at(b["mlp"]["w_out"]["w"], -2) != "model":
                    raise ValueError(f"{pre}: w_in is column-sharded but "
                                     f"w_out is not row-sharded")
                for mod, leaves in b["mlp"].items():
                    for leaf in leaves:
                        roles[f"{pre}.mlp.{mod}.{leaf}"] = \
                            "full" if (mod, leaf) == ("w_out", "b") \
                            else "local"
            fns.setdefault(si, {})[bi] = tp_attn_block(TPBlock(
                group, size, rank, attn, kv_heads, mlp))
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
    D = _dt()
    return D.distribute_tensor(full, like.device_mesh,
                               like.placements).to_local()

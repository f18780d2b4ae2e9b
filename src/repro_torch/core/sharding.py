"""Assignment -> PartitionSpecs -> DTensor placements (twin of
``repro/core/sharding.py``; DESIGN.md §2 table).

Per-leaf partition specs are derived from the parameter tree *path* (module
and leaf names fixed by the model substrate), the component's assigned
Strategy, and divisibility of the dims by the mesh axes — the reference's
rules, copied, so that every spec equals the reference's leaf by leaf.  A
spec is the port's own ``P``: a tuple with one entry a tensor dim, each
None (replicated), a mesh axis name, or a tuple of names that share the
dim (JAX's row-major order: the first name is the major one).

Fallback rule: any dim that an axis does not divide is replicated instead —
uneven shardings are refused, and head-count-dependent reshapes (e.g.
arctic 56 heads, minitron 24 heads vs model=16) would force reshards.  Such
attention mixers keep replicated weights under MP and shard only over
`data` (ZeRO-style) under HP; their FFN halves shard fully.

``placements`` maps a spec onto a ``DeviceMesh`` whose dims are named
``("data", "model")`` or ``("pod", "data", "model")``: one ``Shard(d)`` or
``Replicate()`` a mesh dim.  DTensor orders a tensor dim shared by two mesh
dims by the mesh's order (outer mesh dim major), so a spec that lists the
axes of one dim in another order than the mesh's cannot be placed the
reference's way and raises, naming the spec: on a mesh with a ``pod`` axis
larger than 1, HP's ZeRO dim ``("data", "pod")`` and the int8 moments'
``("data", "model", "pod")`` do (only ``batch_axes``' ``("pod", "data")``,
which the train step slices itself, is in the mesh's order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core.components import SPLIT_KEYS, abstract_params
from repro_torch.core.costmodel import MeshShape
from repro_torch.core.strategy import Strategy

# EP layout for MoE expert stacks: "model" (baseline: experts over `model`,
# expert-tensor over `data` under HP) or "data" (optimized EP-major: experts
# over `data`, expert-FF over `model`)
MOE_EP_AXIS = "model"

# column-parallel modules (shard d_out over `model`); row-parallel (d_in)
COL = {"wq", "wk", "wv", "w_in", "w_gate", "z_proj", "x_proj", "dt_proj",
       "wq_a", "wq_b", "wk_b", "wv_b"}
ROW = {"wo", "w_out", "out_proj"}
# always-replicated small weights (see module docstring)
REPL = {"b_proj", "c_proj", "wkv_a", "router", "conv_b", "conv_c",
        "q_norm", "k_norm", "kv_norm", "norm", "norm1", "norm2", "norm3",
        "final_norm", "gate", "mlp_gate", "dt_bias", "cls", "pos"}


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("data", "pod"), None)``,
    ``P()`` (replicated, any rank).  A one-name tuple entry becomes the
    name, as JAX's ``PartitionSpec`` stores it, so a spec equals
    ``tuple(jax PartitionSpec)`` of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _q_heads_ok(arch: ArchConfig, mesh: MeshShape) -> bool:
    """wq/wo shard iff the (B,S,q_dim@model)->(B,S,H,hd) reshape stays
    sharded, i.e. n_heads % model == 0 (else: arctic 56H, minitron 24H)."""
    return _div(arch.n_heads, mesh.model)


def _kv_heads_ok(arch: ArchConfig, mesh: MeshShape) -> bool:
    """wk/wv shard iff n_kv_heads % model == 0.  When false they stay
    replicated (tiny: D x kv_dim) and layers._expand_kv broadcasts the
    replicated k/v into the q-head-sharded layout."""
    return _div(min(arch.n_kv_heads, arch.n_heads), mesh.model)


def _sanitize(spec: P, shape: tuple, mesh: MeshShape) -> P:
    """Replicate any dim an axis doesn't divide (safety net)."""
    sizes = {"data": mesh.data, "model": mesh.model, "pod": mesh.pod}
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        total = 1
        for a in axes:
            total *= sizes[a]
        out.append(ax if i < len(shape) and _div(shape[i], total) else None)
    return P(*out)


def leaf_spec(names: tuple, shape: tuple, strat: Strategy,
              mesh: MeshShape, arch: ArchConfig) -> P:
    """Spec for an UNSTACKED leaf (stack prefix added by caller)."""
    rank = len(shape)
    mod = names[-2] if len(names) >= 2 else names[-1]
    leaf = names[-1]
    in_moe = "moe" in names
    shared_blk = "shared" in names

    if strat == Strategy.DP:
        return P(*([None] * rank))
    if strat == Strategy.FS:
        # FS weight layout == HP's 2-axis sharding; the difference is the
        # batch/activation layout (over ALL axes), set by the launcher.
        strat = Strategy.HP

    hp = strat == Strategy.HP
    # HP shards the ZeRO dim over pod too (multi-pod: params /512 not /256)
    data_ax = ("data", "pod") if (hp and mesh.pod > 1) else "data"

    # ---- embedding / head -------------------------------------------------
    if leaf == "embedding":
        return P("model", data_ax if hp else None)
    if "head" in names and leaf == "w":
        return P(data_ax if hp else None, "model")
    if "head" in names and leaf == "b":
        return P("model")

    # ---- MoE expert-stacked arrays (E, D, F) / (E, F, D) ------------------
    if in_moe and leaf in ("w_in", "w_gate", "w_out") and rank == 3:
        if MOE_EP_AXIS == "data":
            # EP-major: experts over `data`, expert-FF dim over `model`
            # (w_in/w_gate: (E,D,F) -> F; w_out: (E,F,D) -> F is dim 1)
            return (P("data", None, "model") if leaf in ("w_in", "w_gate")
                    else P("data", "model", None))
        return P("model", data_ax if hp else None, None)

    # ---- norms / replicated -----------------------------------------------
    if mod in REPL or leaf in REPL:
        # mamba2's gated rmsnorm scale lives on the head-sharded d_inner
        if mod == "norm" and "mixer" in names and arch.ssm is not None:
            return P("model")
        return P(*([None] * rank))

    # ---- attention q/k/v/o with head-divisibility gating -------------------
    if mod in ("wq", "wk", "wv", "wo") and not in_moe:
        if shared_blk:                         # zamba2 shared block: full MHA
            ok = _div(arch.n_heads, mesh.model)
        elif mod in ("wk", "wv"):
            ok = _kv_heads_ok(arch, mesh)
        else:
            ok = _q_heads_ok(arch, mesh)
        if not ok:
            # fallback: ZeRO-only sharding under HP, replicate under MP
            if hp and leaf == "w":
                return P(data_ax, None)
            return P(*([None] * rank))

    # mamba2 head-sharded projections need H % model == 0
    if mod in ("z_proj", "x_proj", "dt_proj", "out_proj") and arch.ssm is not None:
        H = (arch.ssm.expand * arch.d_model) // arch.ssm.head_dim
        if not _div(H, mesh.model):
            if hp:
                return P(data_ax, None) if leaf == "w" else P(None)
            return P(*([None] * rank))

    if mod == "conv_x" or (mod in ("conv_x",) and leaf in ("w", "b")):
        return P(None, "model") if leaf == "w" else P("model")
    if leaf in ("A_log", "D") and rank == 1:
        return P("model")

    if mod in COL:
        if leaf == "w":
            return P(data_ax if hp else None, "model")
        return P("model")           # bias on the sharded output dim
    if mod in ROW:
        if leaf == "w":
            return P("model", data_ax if hp else None)
        return P(*([None] * rank))  # bias after the all-reduce: replicated

    if mod == "app_proj":           # zamba2 per-application out projection
        if leaf == "w":
            return P("model", data_ax if hp else None)
        return P(*([None] * rank))
    if mod == "proj":               # mtp concat projection
        return P(None, "model") if leaf == "w" else P("model")

    return P(*([None] * rank))


# ---------------------------------------------------------------------------
# component lookup
# ---------------------------------------------------------------------------

def component_name_of(names: tuple, arch: ArchConfig) -> Optional[str]:
    if names[0] == "embed":
        return "embed"
    if names[0] == "head":
        return "head"
    if names[0] == "mtp":
        return "mtp"
    if names[0] == "encoder":
        return "encoder"
    if names[0] == "final_norm":
        return None
    if names[0] == "shared":
        for si, seg in enumerate(arch.pattern):
            for bi, kind in enumerate(seg.blocks):
                if kind == "shared_attn":
                    return f"seg{si}/b{bi}:shared_attn"
        return None
    if names[0] == "segments":
        si, b = names[1], names[2]
        bi = int(b[1:])
        kind = arch.pattern[si].blocks[bi]
        if kind in SPLIT_KEYS:
            mixer_keys, _ = SPLIT_KEYS[kind]
            sub = "mixer" if names[3] in mixer_keys else "ffn"
            return f"seg{si}/b{bi}:{kind}.{sub}"
        return f"seg{si}/b{bi}:{kind}"
    return None


def _stack_depth(names: tuple) -> int:
    return 1 if names[0] == "segments" or \
        (names[0] == "encoder" and len(names) > 1 and names[1] == "segments") else 0


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------

def _map_params(fn, t, path=()):
    """``fn(names, leaf)`` over a params tree (dicts and lists, tensors at
    the leaves; ``names`` the path of dict keys and list indices, as the
    reference's ``_names_of``) -> a tree of the same nesting."""
    if isinstance(t, dict):
        return {k: _map_params(fn, v, path + (k,)) for k, v in t.items()}
    if isinstance(t, list):
        return [_map_params(fn, v, path + (i,)) for i, v in enumerate(t)]
    return fn(path, t)


def map_specs(fn, t):
    """``fn`` over the ``P`` (and None) leaves of a spec tree."""
    if isinstance(t, dict):
        return {k: map_specs(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [map_specs(fn, v) for v in t]
    if isinstance(t, tuple) and not isinstance(t, P) and \
            not hasattr(t, "_fields"):
        return tuple(map_specs(fn, v) for v in t)
    return fn(t)


def spec_leaves(t) -> list:
    """The leaves of a spec tree (``P``, None, or a QLeaf of specs) in
    ``tree.leaves`` order: dict keys sorted, lists in order."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in spec_leaves(t[k])]
    if isinstance(t, (list, tuple)) and not isinstance(t, P):
        return [x for v in t for x in spec_leaves(v)]
    return [t]


def param_specs(arch: ArchConfig, assignment: dict[str, Strategy],
                mesh: MeshShape):
    """Spec tree mirroring init_lm's params exactly."""
    aparams = abstract_params(arch)

    def rule(names, leaf):
        comp = component_name_of(names, arch)
        strat = assignment.get(comp, Strategy.DP) if comp else Strategy.DP
        depth = _stack_depth(names)
        shape = tuple(leaf.shape)
        spec = leaf_spec(tuple(n for n in names if isinstance(n, str)),
                         shape[depth:], strat, mesh, arch)
        full = P(*([None] * depth + list(spec)))
        return _sanitize(full, shape, mesh)

    return _map_params(rule, aparams)


def batch_axes(mesh: MeshShape, batch: int, *, full: bool = False):
    """Largest batch sharding the mesh allows for this batch size.
    full=True (FS / uniform-DP): batch over every axis when divisible."""
    if full:
        axes = tuple(a for a, n in (("pod", mesh.pod), ("data", mesh.data),
                                    ("model", mesh.model)) if n > 1)
        total = mesh.chips
        if axes and _div(batch, total):
            return axes
    if mesh.pod > 1 and _div(batch, mesh.pod * mesh.data):
        return ("pod", "data")
    if _div(batch, mesh.data):
        return "data"
    return None


def token_spec(mesh: MeshShape, batch: int, *, full: bool = False) -> P:
    return P(batch_axes(mesh, batch, full=full), None)


def opt_state_specs(opt_sds, param_specs_tree, mesh: MeshShape):
    """Specs for an OptState (the port's: a tree of tensors, or of
    ``QLeaf``s, a moment; shapes are all that is read).

    fp32 moments mirror the param specs (ZeRO follows the HP params for
    free).  Int8 QLeaf moments are flat (n_blocks, 256) — shard dim0 over
    every mesh axis that divides it (fully-sharded optimizer state); the
    result holds a ``QLeaf`` of specs (codes', scales') for each.
    """
    from repro_torch.optim.quantized import QLeaf

    def flat_rule(shape):
        n = shape[0]
        for axes in ((("data", "model", "pod") if mesh.pod > 1
                      else ("data", "model")),
                     ("data", "model"), ("data",), None):
            if axes is None:
                return P(*([None] * len(shape)))
            total = 1
            sizes = {"data": mesh.data, "model": mesh.model, "pod": mesh.pod}
            for a in axes:
                total *= sizes[a]
            if _div(n, total):
                return P(axes, *([None] * (len(shape) - 1)))

    def moment_specs(m):
        if any(isinstance(x, QLeaf) for x in tree.leaves(m)):
            return tree.map(lambda q: QLeaf(flat_rule(tuple(q.q.shape)),
                                            flat_rule(tuple(q.scale.shape)),
                                            q.shape, q.signed), m)
        return param_specs_tree

    step, mu, nu, extra = opt_sds
    return type(opt_sds)(P(), moment_specs(mu), moment_specs(nu),
                         None if extra is None else
                         tree.map(lambda x: flat_rule(tuple(x.shape)), extra))


def cache_specs(arch: ArchConfig, assignment: dict[str, Strategy],
                mesh: MeshShape, batch: int):
    """Spec tree mirroring the reference's contiguous ``init_cache``:
    per-segment stacked block caches (planning only: the port serves
    through the paged pools)."""
    ba = batch_axes(mesh, batch)

    def kv_time_spec(strat, extra_rank):
        # (repeat, B, T, ...) — time axis sharded over `model` under MP/HP
        t_ax = "model" if strat in (Strategy.MP, Strategy.HP) else None
        return P(None, ba, t_ax, *([None] * extra_rank))

    specs = []
    for si, seg in enumerate(arch.pattern):
        seg_spec = {}
        for bi, kind in enumerate(seg.blocks):
            if kind in SPLIT_KEYS:
                comp = f"seg{si}/b{bi}:{kind}.mixer"
            else:
                comp = f"seg{si}/b{bi}:{kind}"
            strat = assignment.get(comp, Strategy.DP)
            if kind in ("attn", "moe_attn"):
                seg_spec[f"b{bi}"] = {"k": kv_time_spec(strat, 2),
                                      "v": kv_time_spec(strat, 2),
                                      "pos": P(None)}
            elif kind in ("mla", "mla_dense"):
                seg_spec[f"b{bi}"] = {"c_kv": kv_time_spec(strat, 1),
                                      "k_rope": kv_time_spec(strat, 1),
                                      "pos": P(None)}
            elif kind == "mamba2":
                H = (arch.ssm.expand * arch.d_model) // arch.ssm.head_dim
                h_ax = "model" if (strat in (Strategy.MP, Strategy.HP)
                                   and _div(H, mesh.model)) else None
                seg_spec[f"b{bi}"] = {
                    "conv_x": P(None, ba, None, h_ax),
                    "conv_b": P(None, ba, None, None),
                    "conv_c": P(None, ba, None, None),
                    "ssm": P(None, ba, h_ax, None, None)}
            elif kind == "cross_attn":
                seg_spec[f"b{bi}"] = {"k": P(None, ba, None, None, None),
                                      "v": P(None, ba, None, None, None)}
            elif kind == "wdec":
                seg_spec[f"b{bi}"] = {
                    "self": {"k": kv_time_spec(strat, 2),
                             "v": kv_time_spec(strat, 2), "pos": P(None)},
                    "cross": {"k": P(None, ba, None, None, None),
                              "v": P(None, ba, None, None, None)}}
            elif kind == "shared_attn":
                t_ax = "model" if (strat in (Strategy.MP, Strategy.HP)) else None
                seg_spec[f"b{bi}"] = {"k": P(None, ba, t_ax, None, None),
                                      "v": P(None, ba, t_ax, None, None),
                                      "pos": P(None)}
            else:
                seg_spec[f"b{bi}"] = None
        specs.append(seg_spec)
    return specs


def paged_cache_specs(arch: ArchConfig, assignment: dict[str, Strategy],
                      mesh: MeshShape):
    """Spec tree mirroring ``transformer.init_paged_cache``: per-segment
    stacked pools for both serving state classes.

    attn-family block pools are (repeat, num_blocks, block_size, Hkv,
    head_dim): their kv-head axis shards over `model` whenever the head
    count divides, else the pool is replicated.  Slot-state pools have a
    leading (repeat, slots+1) prefix: mamba2 state shards its SSM head axis
    over `model`; cross-attn K/V shards its kv-head axis like the attn
    pools.  zamba2's shared block pages a full-MHA pool per application
    (head axis over `model` when n_heads divides); whisper's wdec carries
    a paged self-attn pool plus a slot-state encoder-K/V pool; MLA's latent
    (c_kv, k_rope) pools are replicated.

    Specs come in the reference's canonical form (trailing Nones
    stripped, fully replicated as P()); the engine places its pools by
    them on a mesh (``serving/placement.py``)."""
    def _canon(spec):
        parts = tuple(spec)
        while parts and parts[-1] is None:
            parts = parts[:-1]
        return P(*parts)

    specs = []
    for si, seg in enumerate(arch.pattern):
        seg_spec = {}
        for bi, kind in enumerate(seg.blocks):
            if kind not in ("attn", "moe_attn", "mamba2", "cross_attn",
                            "mla", "mla_dense", "shared_attn", "wdec"):
                raise ValueError(
                    f"paged/slot-state cache unsupported for block kind "
                    f"{kind!r}")
            comp = f"seg{si}/b{bi}:{kind}.mixer" if kind in SPLIT_KEYS \
                else f"seg{si}/b{bi}:{kind}"
            strat = assignment.get(comp, Strategy.DP)
            mp = strat in (Strategy.MP, Strategy.HP)
            if kind == "mamba2":
                H = (arch.ssm.expand * arch.d_model) // arch.ssm.head_dim
                h_ax = "model" if (mp and _div(H, mesh.model)) else None
                seg_spec[f"b{bi}"] = {
                    "conv_x": P(None, None, None, h_ax),
                    "conv_b": P(None, None, None, None),
                    "conv_c": P(None, None, None, None),
                    "ssm": P(None, None, h_ax, None, None)}
                continue
            if kind in ("mla", "mla_dense"):
                seg_spec[f"b{bi}"] = {"c_kv": P(None, None, None, None),
                                      "k_rope": P(None, None, None, None)}
                continue
            if kind == "shared_attn":
                h_ax = "model" if (mp and _div(arch.n_heads, mesh.model)) \
                    else None
                pool = P(None, None, None, h_ax, None)
                seg_spec[f"b{bi}"] = {"k": pool, "v": pool}
                continue
            h_ax = "model" if (mp and _kv_heads_ok(arch, mesh)) else None
            pool = P(None, None, None, h_ax, None)
            if kind == "wdec":
                seg_spec[f"b{bi}"] = {"self": {"k": pool, "v": pool},
                                      "cross": {"k": pool, "v": pool}}
                continue
            seg_spec[f"b{bi}"] = {"k": pool, "v": pool}
        specs.append(seg_spec)
    return map_specs(_canon, specs)


# ---------------------------------------------------------------------------
# placements on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """``spec`` on ``mesh`` (a ``DeviceMesh`` with named dims): a
    ``Shard(d)`` for each mesh dim that shards tensor dim d, else
    ``Replicate()``.  Raises, naming the spec, where it names an axis the
    mesh lacks, or shards one dim over axes in another order than the
    mesh's (DTensor would lay the shards out in another order than JAX)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec!r} names mesh axes {missing} that "
                             f"the mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec!r} shards dim {d} over {axes}, not in the "
                f"mesh's order {names}: DTensor makes the outer mesh dim "
                f"major where the reference makes {axes[0]!r} major")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(eq=False)
class NamedSharding:
    """A spec on a mesh (the port's ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def batch_slice(sharding: NamedSharding, rows: int) -> slice:
    """This rank's rows of a global batch of ``rows`` laid out by
    ``sharding`` (its spec's dim 0: None, an axis, or axes in JAX's
    row-major order, the first major — computed here, so any order)."""
    ax = sharding.spec[0] if len(sharding.spec) else None
    if ax is None:
        return slice(0, rows)
    mesh = sharding.mesh
    names = tuple(mesh.mesh_dim_names)
    idx, n = 0, 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        i = names.index(a)
        idx = idx * mesh.shape[i] + mesh.get_local_rank(mesh_dim=i)
        n *= mesh.shape[i]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{ax!r} ({n} shards)")
    k = rows // n
    return slice(idx * k, (idx + 1) * k)


def distribute(t, sharding: NamedSharding):
    """``t`` (the same full tensor on every rank) placed by ``sharding``:
    a DTensor holding this rank's shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def shardings(spec_tree, mesh):
    """A ``NamedSharding`` for each spec of ``spec_tree``."""
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def shard_of(full, mesh, placements: tuple):
    """This rank's shard of ``full`` (the same on every rank) under
    ``placements``, as DTensor lays it out: chunked along each sharding
    mesh dim of more than one rank, outer mesh dim first.  A view of
    ``full``, and ``full`` itself where no such mesh dim shards it."""
    from torch.distributed.tensor import Shard
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.shape[i] > 1:
            full = full.chunk(mesh.shape[i], pl.dim)[
                mesh.get_local_rank(mesh_dim=i)]
    return full


def place(t, sharding_tree):
    """A tree of tensors (the same on every rank) as DTensors placed by a
    tree of ``NamedSharding`` of the same leaf order.  Each DTensor wraps
    this rank's shard: its own copy where the leaf is split, the leaf
    itself where it is not (so a world of 1 copies nothing).  A leaf that
    already is a DTensor on the sharding's mesh and placements (each rank
    made its own shard, never holding the whole leaf) is kept as it is."""
    from torch.distributed.tensor import DTensor
    nss = tree.leaves(sharding_tree)
    xs = tree.leaves(t)
    if len(nss) != len(xs):
        raise ValueError(f"{len(xs)} leaves but {len(nss)} shardings")
    out = []
    for x, ns in zip(xs, nss):
        pl = ns.placements
        if isinstance(x, DTensor):
            if x.device_mesh != ns.mesh or tuple(x.placements) != tuple(pl):
                raise ValueError(f"a DTensor leaf placed {x.placements}, "
                                 f"not as its sharding {pl}")
            out.append(x)
            continue
        local = shard_of(x, ns.mesh, pl)
        if local is not x:
            local = local.clone()
        out.append(DTensor.from_local(local, ns.mesh, pl, run_check=False,
                                      shape=x.shape, stride=x.stride()))
    return tree.unflatten(t, out)

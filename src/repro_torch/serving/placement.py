"""The serving engine on a ``DeviceMesh`` (the mesh path of the reference's
``repro/serving/engine.py``): params and pools as DTensors placed by the
ASA plan's specs, and the trees and block functions the paged steps run
on.

Every rank runs the engine's host loop on the same inputs, and the
scheduler, the block allocator and the sampler's host rows are
deterministic, so every rank makes the same model calls on the same
token rows; ranks along `data` compute the same values, and the `model`
ranks split what the plan shards:

  * every block kind under MP / HP computes on its own share
    (``runtime/sharded.py``'s tensor-parallel blocks) and works on its
    pool shards in place: an attention's Q heads and the KV heads of its
    pool shard (``attn`` and ``moe_attn``, zamba2's per-application pools,
    whisper's self pool and its cross slot rows, llama-vision's cross
    slot rows), mamba2's heads and its ``conv_x`` and ``ssm`` slot rows,
    MLA's heads, the MLP's slice of d_ff, the MoE layer's range of
    experts, with one all-reduce after each row-parallel projection or
    MoE FFN (and one a gated norm).  mamba2's ``conv_b`` and ``conv_c``
    pools and MLA's latent pools stay replicated: every `model` rank
    computes the same B and C, or the same latents, so each rank's copy
    stays whole and valid.  The encoder runs on its own heads too, at
    admission, where each rank writes its own heads of the cross K/V;
  * a block whose pools the plan splits while the weights that use them
    run whole (a uniform plan makes none; an ASA plan may lay out a pool
    by one component's strategy and the weights by another's) gathers
    the pool shards around the block call, then writes back only this
    rank's slice: correct, not parallel.  Admission gathers such a
    block's slot-state pools the same way.

The kernels are ctypes calls on local tensors, which DTensor dispatch
never reaches.  On a world of 1 the steps see the local tensors, which
are the whole ones: no collective and no DTensor dispatch runs in a step.
"""
from __future__ import annotations

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import sharding as SH
from repro_torch.models import blocks as B
from repro_torch.runtime import sharded as SD
from repro_torch.serving.cache_manager import SLOT_STATE_KINDS


def _local(t):
    return t.to_local()


def _pls_map(fn, t):
    """``fn`` over the leaves of a tree of placements tuples (dicts and
    lists are containers, a tuple is a leaf)."""
    if isinstance(t, dict):
        return {k: _pls_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_pls_map(fn, v) for v in t]
    return fn(t)


def _pls_leaves(t) -> list:
    if isinstance(t, dict):
        return [x for v in t.values() for x in _pls_leaves(v)]
    return [t]


def _is_split(pl: tuple, mesh) -> bool:
    D = SD._dt()
    return any(isinstance(p, D.Shard) and mesh.shape[i] > 1
               for i, p in enumerate(pl))


def _gather_tree(local: dict, pls: dict, mesh) -> dict:
    """A dict of pool leaves (nested for wdec) with every split leaf
    gathered whole."""
    return {k: (_gather_tree(v, pls[k], mesh) if isinstance(v, dict)
                else SD.gather_full(v, mesh, pls[k]))
            for k, v in local.items()}


def _write_back(local: dict, full: dict, pls: dict, mesh) -> None:
    """Copy this rank's slice of each gathered leaf back into its shard."""
    for k, v in local.items():
        if isinstance(v, dict):
            _write_back(v, full[k], pls[k], mesh)
        elif full[k] is not v:
            v.copy_(SH.shard_of(full[k], mesh, pls[k]))


def _gathered_block(fn, pls: dict, mesh):
    """``fn`` (``apply_block``'s signature) with its pool shards gathered
    around the call and this rank's slices written back after it."""
    def apply(p, kind, arch, x, *, cache=None, **kw):
        if cache is None:
            return fn(p, kind, arch, x, cache=cache, **kw)
        full = _gather_tree(cache, pls, mesh)
        x, _, aux = fn(p, kind, arch, x, cache=full, **kw)
        _write_back(cache, full, pls, mesh)
        return x, cache, aux
    return apply


class Placement:
    """The engine's params (``params``) as DTensors on ``mesh``, placed by
    the plan's ``param_specs``, beside its pools (DTensors placed by
    ``pool_specs``); ``step_params()``, ``step_pools`` and ``block_fns``
    are what the paged steps run on, ``admit`` the slot admission around
    them.

    A pool the plan replicates while a tensor-parallel ``attn`` block runs
    on it (KV heads that do not divide the `model` axis, or weights alone
    sharded) holds, on each `model` rank, valid rows only for that rank's
    heads.  Pools are therefore read only through the steps: nothing may
    read one whole (``full_tensor``, a redistribute, a checkpoint), which
    would return one rank's partial copy without an error."""

    def __init__(self, arch: ArchConfig, mesh, params, pools, param_specs,
                 pool_specs):
        self.arch, self.mesh = arch, mesh
        self.world = mesh.size()
        pns = SH.shardings(param_specs, mesh)
        self.params = SH.place(params, pns)
        # the pools, placed by the cache manager: the steps write their
        # local tensors in place
        self.step_pools = tree.map(_local, pools)
        local = tree.map(_local, self.params)
        self.block_fns = None
        # the (segment, block)s whose pool shards are gathered around them
        self._gathered = set()
        if self.world == 1:
            self._work = local
            return
        self._work = None
        self._live = tree.leaves(local)
        roles, tp_fns = SD.plan_layout(arch, param_specs, mesh, SH.P(None))
        self._lays = SD.layouts(pns, roles)
        # each pool leaf's placements (``_pool_pls``), and one
        # application's (the repeat axis, dim 0, is never sharded)
        self._pool_pls = SH.map_specs(lambda ns: ns.placements,
                                      SH.shardings(pool_specs, mesh))
        app_pls = _pls_map(SD._shift, self._pool_pls)
        fns = {k: v for k, v in tp_fns.items() if k == "encoder"}
        for si, seg in enumerate(arch.pattern):
            for bi, kind in enumerate(seg.blocks):
                fn = tp_fns.get(si, {}).get(bi)
                pls = app_pls[si][f"b{bi}"]
                split = any(_is_split(pl, mesh) for pl in _pls_leaves(pls))
                # a tensor-parallel block works on its own pool shards;
                # any other block gathers the shards around it
                if split and not getattr(fn, "own_pools", False):
                    fn = _gathered_block(fn or B.apply_block, pls, mesh)
                    self._gathered.add((si, bi))
                if fn is not None:
                    fns.setdefault(si, {})[bi] = fn
        self.block_fns = fns

    def step_params(self):
        """The params tree a step runs on: the local tensors on a world
        of 1; else each leaf gathered on use (``SD.working_tree``), the
        tensor-parallel blocks' leaves kept as their `model` shards."""
        if self._work is not None:
            return self._work
        return SD.working_tree(self.params, self._live, self._lays,
                               self.mesh)

    def admit(self, admit_fn, params, slot: int, frontend):
        """``admit_fn(params, pools, slot, frontend)`` (the slot admission
        step) on the pools as the steps see them: a tensor-parallel
        block's shards as they are (each rank writes its own heads), the
        split slot-state pools of a block that gathers them around its
        calls gathered around this one too."""
        if not self._gathered:
            admit_fn(params, self.step_pools, slot, frontend)
            return
        pools = [dict(seg) for seg in self.step_pools]
        gathered = []
        for si, seg in enumerate(self.arch.pattern):
            for bi, kind in enumerate(seg.blocks):
                if kind not in SLOT_STATE_KINDS or \
                        (si, bi) not in self._gathered:
                    continue
                key = f"b{bi}"
                local, pls = pools[si][key], self._pool_pls[si][key]
                if kind == "wdec":
                    local, pls = local["cross"], pls["cross"]
                full = _gather_tree(local, pls, self.mesh)
                gathered.append((local, full, pls))
                pools[si][key] = (dict(pools[si][key], cross=full)
                                  if kind == "wdec" else full)
        admit_fn(params, pools, slot, frontend)
        for local, full, pls in gathered:
            _write_back(local, full, pls, self.mesh)


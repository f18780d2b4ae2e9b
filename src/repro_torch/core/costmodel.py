"""ASA cost model — t_comp / t_comm / mem per (component, strategy)
(paper §III-C), re-expressed for a (pod, data, model) mesh; copy of
``repro/core/costmodel.py`` (pure Python: the plans equal the reference's
for the same inputs).

Two operating modes (DESIGN.md §4):
  faithful=True  — the paper's model: per-component computation + strategy
                   communication terms only (no transition/resharding costs).
  faithful=False — adds activation-resharding costs at strategy boundaries,
                   pod-axis (DCN) gradient reduction, and bandwidth-bound
                   compute (max(flops, HBM) per component).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import hardware as HW
from repro_torch.core.components import Component
from repro_torch.core.strategy import Strategy

PARAM_BYTES = 2       # bf16 params
GRAD_BYTES = 4        # fp32 gradient reduction
OPT_BYTES = 12        # AdamW: fp32 m + v + master


@dataclasses.dataclass(frozen=True)
class MeshShape:
    data: int
    model: int
    pod: int = 1

    @property
    def chips(self):
        return self.data * self.model * self.pod


@dataclasses.dataclass
class CostTerms:
    t_comp: float
    t_comm: float
    mem_params: float      # per-device bytes: params + grads + optimizer
    mem_act: float         # per-device bytes: activations / KV cache

    @property
    def time(self):
        return self.t_comp + self.t_comm


@dataclasses.dataclass
class CostModel:
    hw: HW.HardwareProfile
    mesh: MeshShape
    mode: str = "train"            # train | prefill | decode
    faithful: bool = True
    remat: str = "selective"       # none | selective | full
    microbatches: int = 1          # grad-accumulation chunks (train act memory)
    seq_sharded: bool = False      # Megatron-SP: layer-boundary activations
                                   # sharded over `model` on the seq axis
    fs_allowed: bool = True        # FS requires global_batch % chips == 0
    moe_ep: bool = False           # EP-major MoE: experts over `data`,
                                   # expert-FF over `model` (a2a dispatch)
    opt_bytes_per_param: float = OPT_BYTES
    grad_bytes: float = GRAD_BYTES
    param_bytes: float = PARAM_BYTES
    # per-component measured-time calibration (profiler feedback), name->factor
    calibration: Optional[dict] = None

    # activation-memory multiplier per remat policy (how many activation-sized
    # tensors a block keeps for backward; calibrated against dry-run
    # memory_analysis — "full" still stores the bf16 layer-input stack plus
    # XLA's hoisted f32 convert of it, ~3 act-sized tensors)
    _REMAT_FACTOR = {"none": 16.0, "selective": 8.0, "full": 3.0}

    # ------------------------------------------------------------------
    def component_cost(self, c: Component, s: Strategy, *,
                       uniform: bool = False) -> CostTerms:
        """Cost of running component `c` under strategy `s`.

        uniform=True evaluates the strategy as a *global static* scheme
        (baselines): DP then shards batch over every mesh axis.
        """
        m = self.mesh
        train = self.mode == "train"
        eff_flops = self.hw.peak_flops * self.hw.matmul_efficiency

        # ---- compute ----------------------------------------------------
        flops = c.total_flops_fwd * (3.0 if train else 1.0)
        if s == Strategy.DP:
            # DP-full: batch over all chips (uniform) or over data axis with
            # the model axis idle (mixed assignment, replicated compute).
            denom = m.chips if uniform else m.data * m.pod * (
                m.model if uniform else 1)
        else:
            denom = m.chips
        t_comp = flops / denom / eff_flops

        # params resident per device under s (HP/FS: ZeRO over data+pod/all)
        shard = {Strategy.DP: 1,
                 Strategy.MP: m.model,
                 Strategy.HP: m.model * m.data * m.pod,
                 Strategy.FS: m.chips}[s]
        if self.moe_ep and c.moe_a2a_bytes > 0 and s in (Strategy.MP,
                                                         Strategy.HP):
            shard = m.data * m.model    # EP-major: E@data x FF@model
        p_local = c.total_params * self.param_bytes / shard

        if not self.faithful:
            # bandwidth-bound floor: reading weights + activations from HBM
            bytes_touched = p_local + c.act_bytes * c.count / (m.data * m.pod)
            t_comp = max(t_comp, bytes_touched / self.hw.hbm_bw)

        if self.calibration and c.name in self.calibration:
            t_comp *= self.calibration[c.name]

        # ---- communication ----------------------------------------------
        t_comm = 0.0
        act_local = c.act_bytes / (m.data * m.pod)     # batch-sharded activation
        is_moe = c.moe_a2a_bytes > 0
        if train:
            gbytes = c.total_params * self.grad_bytes
            if s == Strategy.FS:
                # ZeRO-3 over all chips: ag(bf16 params) fwd + bwd + rs(grads)
                # — gathers repeat per microbatch (grad accumulation)
                pb = c.total_params * self.param_bytes
                t_comm += 2 * self.microbatches * HW.allgather_time(
                    pb, m.chips, self.hw.link_bw)
                t_comm += HW.reducescatter_time(gbytes, m.chips,
                                                self.hw.link_bw)
            elif s == Strategy.DP:
                n = m.chips if uniform else m.data
                t_comm += HW.ring_allreduce_time(gbytes, n, self.hw.link_bw)
            elif s == Strategy.MP:
                t_comm += HW.ring_allreduce_time(gbytes / m.model, m.data,
                                                 self.hw.link_bw)
            elif is_moe and self.moe_ep:
                # EP-major: dispatch/combine a2a only (counted below);
                # grads stay fully sharded — reduce only router/shared bits
                t_comm += HW.ring_allreduce_time(
                    gbytes / (m.model * m.data), m.data, self.hw.link_bw)
            elif is_moe:
                # HP for MoE = EP over `model` x expert-tensor over `data`:
                # partial-sum all-reduces of the expert outputs over `data`
                # (3x: fwd + bwd wrt act + bwd wrt weights) — no ZeRO gather.
                t_comm += 3 * HW.ring_allreduce_time(act_local, m.data,
                                                     self.hw.link_bw)
                t_comm += HW.ring_allreduce_time(
                    gbytes / (m.model * m.data), m.data, self.hw.link_bw)
            else:  # HP / ZeRO-3: ag fwd + ag bwd + rs grads over data (+pod)
                pb = c.total_params * self.param_bytes / m.model
                t_comm += 2 * self.microbatches * HW.allgather_time(
                    pb, m.data, self.hw.link_bw)
                t_comm += HW.reducescatter_time(
                    c.total_params * self.grad_bytes / m.model, m.data,
                    self.hw.link_bw)
                if m.pod > 1:   # gather the pod-resident shard over DCN
                    t_comm += 2 * self.microbatches * HW.allgather_time(
                        pb / m.data, m.pod, self.hw.dcn_bw or self.hw.link_bw)
            if not self.faithful and m.pod > 1:
                # pod-axis (DCN) gradient reduction of the local shard
                t_comm += HW.ring_allreduce_time(
                    gbytes / shard, m.pod, self.hw.dcn_bw or self.hw.link_bw)
        else:
            if s == Strategy.FS:                  # gathers weights per step
                t_comm += HW.allgather_time(c.total_params * self.param_bytes,
                                            m.chips, self.hw.link_bw)
            elif s == Strategy.HP and not is_moe:  # ZeRO-3 gathers per step
                pb = c.total_params * self.param_bytes / m.model
                t_comm += HW.allgather_time(pb, m.data, self.hw.link_bw)
            elif s == Strategy.HP and is_moe:
                t_comm += HW.ring_allreduce_time(act_local, m.data,
                                                 self.hw.link_bw)

        if s in (Strategy.MP, Strategy.HP):
            # model-axis activation all-reduces (fwd; x3 for train incl. bwd);
            # sequence parallelism replaces each all-reduce with
            # reduce-scatter + all-gather == same ring bytes, half the
            # redundant traffic => 0.5x effective
            sp = 0.5 if self.seq_sharded else 1.0
            n_ar = c.n_model_allreduce * c.count * (3.0 if train else 1.0)
            t_comm += sp * n_ar * HW.ring_allreduce_time(act_local, m.model,
                                                         self.hw.link_bw)
            if c.moe_a2a_bytes:
                a2a = c.moe_a2a_bytes * c.count / (m.data * m.pod)
                t_comm += (3.0 if train else 1.0) * HW.alltoall_time(
                    a2a, m.model, self.hw.link_bw)

        # ---- memory -------------------------------------------------------
        mem_params = p_local * (1 + (self.grad_bytes + self.opt_bytes_per_param)
                                / self.param_bytes if train else 1)
        if train:
            # only the live microbatch's activations are resident (grad accum)
            batch_shards = m.chips if s == Strategy.FS else m.data * m.pod
            mem_act = c.act_bytes * c.count / batch_shards * \
                self._REMAT_FACTOR[self.remat] / self.microbatches
            if s in (Strategy.MP, Strategy.HP) and (
                    self.seq_sharded or c.kind in ("embed", "head")):
                # embed/head activations are the vocab-sharded logits under
                # MP/HP; other layers shard only with sequence parallelism
                mem_act /= m.model
        else:
            kv_shard = m.model if s in (Strategy.MP, Strategy.HP) else 1
            mem_act = c.kv_bytes * c.count / (m.data * m.pod) / kv_shard
        return CostTerms(t_comp, t_comm, mem_params, mem_act)

    # ------------------------------------------------------------------
    def transition_cost(self, prev: Strategy, nxt: Strategy,
                        act_bytes: float) -> float:
        """Activation resharding at a strategy boundary (optimized mode only):
        DP-full <-> MP/HP implies batch-axis redistribution (all-to-all)."""
        if self.faithful or prev == nxt:
            return 0.0
        if Strategy.DP in (prev, nxt):
            return HW.alltoall_time(act_bytes / (self.mesh.data * self.mesh.pod),
                                    self.mesh.model, self.hw.link_bw)
        return 0.0

    # ------------------------------------------------------------------
    def assignment_cost(self, comps: list[Component],
                        assignment: dict[str, Strategy], *,
                        uniform: bool = False) -> dict:
        """Total per-step cost + per-device memory of an assignment."""
        t_comp = t_comm = mem = 0.0
        prev: Optional[Strategy] = None
        for c in comps:
            s = assignment[c.name]
            ct = self.component_cost(c, s, uniform=uniform)
            t_comp += ct.t_comp
            t_comm += ct.t_comm
            mem += ct.mem_params + ct.mem_act
            if prev is not None:
                t_comm += self.transition_cost(prev, s, c.act_bytes)
            prev = s
        return {"t_comp": t_comp, "t_comm": t_comm, "time": t_comp + t_comm,
                "mem_per_device": mem,
                "comm_fraction": t_comm / max(t_comp + t_comm, 1e-12)}


# ---------------------------------------------------------------------------
# serving-step predictions — the analytic side of the static-cost contract.
# analysis/ircost.py counts the same quantities while a step runs once;
# analysis/tracecheck.py (cost-drift analyzer) gates on their agreement
# (``--write-bench PATH`` writes the pair; no copy is committed).
# ---------------------------------------------------------------------------

# Relative FLOP tolerance between predict_serving_step and a step's counted
# FLOPs (FlopCounterMode's formulas for each op, each hand-written kernel's
# own).  The analytic model counts the projections and attention; the count
# adds every other product the step runs — agreement is structural, not
# exact.  The reference's value, held over the
# registry archs by tests/test_torch_tracecheck.py.
SERVING_FLOPS_RTOL = 0.5

# A step's counted bytes charge every input and output of every non-view
# op (each kernel's formula for it); the analytic estimate counts params +
# cache pools + boundary activations once.  Only order-of-magnitude
# agreement is meaningful.
SERVING_BYTES_RFACTOR = 16.0


def predict_serving_step(arch, *, batch: int, new_tokens: int,
                         table_len: int) -> dict:
    """Analytic cost of ONE paged serving step (forward only).

    ``new_tokens`` is the tokens computed per row this step: the prefill
    chunk size C for paged_prefill, 1 for paged_decode.  ``table_len`` is
    the padded per-row attention capacity ``max_blocks_per_seq *
    block_size`` — paged attention scores every query against that full
    (masked) span, so it is the effective T for score/gather FLOPs AND the
    per-row cache bytes touched.

    Returns {"flops", "bytes"} — floats, whole batch, per step.
    """
    from repro_torch.core.components import build_components

    mode = "decode" if new_tokens == 1 else "prefill"
    seq_len = table_len if mode == "decode" else new_tokens
    comps = build_components(arch, seq_len=seq_len, batch=batch, mode=mode,
                             attn_span=table_len, moe_capacity=True)
    db = 4 if arch.param_dtype == "float32" else 2
    flops = sum(c.total_flops_fwd for c in comps)
    # kv_bytes/act_bytes are bf16-denominated in components.py; rescale.
    cache = sum(c.kv_bytes * c.count for c in comps) * (db / PARAM_BYTES)
    acts = sum(c.act_bytes * c.count for c in comps) * (db / PARAM_BYTES)
    params = sum(c.total_params for c in comps) * db
    return {"flops": float(flops), "bytes": float(params + cache + 2 * acts)}

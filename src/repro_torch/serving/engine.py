"""Continuous-batching engine over paged KV and slot-state pools (twin of
``repro/serving/engine.py``) on one device.

Requests and results are two typed objects: ``Request`` is input-only and
never mutated; ``RequestOutput`` carries token ids, ``finish_reason``
("stop" on a stop-token hit, "length" on the max_new_tokens / max_len
budget, or the reason given to ``cancel``), optional logprobs, and
TTFT/TPOT joined from ServingMetrics.

Entry points: ``submit()`` + ``step()``/``run_until_drained()``,
``generate(requests)`` for submit-and-drain, ``stream(requests)`` yielding
(request_id, token) pairs, an ``on_token`` callback, ``cancel(rid,
reason)`` for a queued or running request and ``outstanding_tokens()``
(the load a cluster router balances on).

Engine step = admit -> one prefill chunk -> one decode step:
  1. every free slot pulls from the RequestScheduler (priority/FCFS +
     max-tokens budget, footprints capped at max_len) if its context's
     blocks fit the pool, and its slot-state rows are reset — mamba2
     state zeroed, cross K/V computed once from the request's
     ``frontend`` (whisper's encoder runs here, never per step) — at
     every admission, re-admission after preemption included.  With
     ``share_prefix`` (purely paged archs only) admission first matches
     the longest cached full-block prefix: matched blocks are
     refcount-shared and prefill starts at the matched boundary;
  2. the oldest prefilling request advances one chunk; finishing the prompt
     samples its first token (TTFT);
  3. all decoding slots advance one token.  A slot needing a new block under
     cache pressure first evicts unreferenced prefix-cache blocks, then
     preempts the request with the largest resident footprint
     (recompute-style: blocks dropped, request requeued with
     prompt+generated as its new prefill).

The steps (runtime/steps.py) run eagerly and write the pools in place;
the sampler (serving/sampling.py) is fused into them, so only a (B,)
token vector comes back to the host per step.  Each row carries its own
(temperature, top_k, top_p, seed) host row (``_sampling_rows``); a
request's seed is ``SamplingParams.seed`` or its id, and its draws are
keyed ``fold_in(PRNGKey(seed), absolute position)``, so a
recompute-preempted request regenerates bit-identical tokens.  An
all-greedy batch takes the greedy branch, chosen on the host.

The port serves archs built of every block kind of the reference's
decoders — ``attn``, ``moe_attn``, ``mla``, ``mla_dense``, ``mamba2``,
``shared_attn``, ``cross_attn`` and ``wdec`` (serving/cache_manager.py
owns both state classes; zamba2's shared block pages its KV in a pool
per application, MLA blocks page latent (c_kv, k_rope) pools, cross_attn
and wdec hold each request's cross K/V in slot rows); ``enc_attn`` in a
decoder raises ``ValueError`` and an unknown kind ``NotImplementedError``
at construction.

Observability, as the reference's: every step is phase-timed (admission /
prefix-match / prefill chunk / decode / sample host-sync) into the
ServingMetrics histograms; a ``StepMonitor`` (core/profiler.py) tracks
the step-time EMA drift; an optional ``tracer`` (serving/tracing.py
ChromeTracer) records the same clock values as Perfetto-loadable spans —
phase tracks plus a lifecycle span per request with admitted /
first_token / preempt / resume annotations — and with ``tracer=None`` no
trace work happens; an optional ``snapshot`` (serving/export.py
SnapshotWriter) appends a windowed-signal JSONL line every N seconds of
engine time; an optional ``sanitizer`` (analysis/sanitizer.py, or
``REPRO_SANITIZE=1`` in the environment) cross-checks the block
allocator after every step and at drain.

Placement, as the reference's: ``plan`` is the ASA plan for the serve
shape ``ShapeSpec("serve", max_len, slots, "decode")`` on the mesh's
shape (``MeshShape(1, 1)`` without a mesh), from ``asa`` or
``AdaptiveScheduler(faithful=False)``.  With a ``mesh`` (a
``DeviceMesh``, ``launch/mesh.py``) the engine runs on the mesh's device,
its params are DTensors placed by ``plan.param_specs()`` and its pools by
``plan.paged_cache_specs()``, and every rank runs this host loop on the
same inputs: the scheduler, the allocator and the sampler's host rows
are deterministic, so the ranks make the same model calls, and the steps
split what the plan shards (``serving/placement.py``: the attn, mamba2,
shared, wdec and cross_attn blocks by heads and d_ff on their own pool
shards, the MLA and MoE blocks gathered around their calls).
On a world of 1 the steps see the local tensors.  Without a mesh the
engine runs unplaced on ``device`` and computes ``plan`` when it is
first read (planning a large model takes seconds of host time that the
unplaced engine does not need).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.core.costmodel import MeshShape
from repro_torch.core.profiler import StepMonitor
from repro_torch.launch.mesh import mesh_device, mesh_shape_of
from repro_torch.models import blocks as B
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as ST
from repro_torch.serving.cache_manager import UnifiedCacheManager
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged_cache import PagedCacheConfig, blocks_for
from repro_torch.serving.placement import Placement
from repro_torch.serving.sampling import GREEDY, SamplingParams, make_sampler
from repro_torch.serving.scheduler import RequestScheduler

@dataclasses.dataclass
class Request:
    """Input-only request description.  The engine never mutates it, so a
    finished Request may be resubmitted as-is (its id must not be in
    flight)."""
    id: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    priority: int = 0                # lower = more urgent
    sampling: SamplingParams = GREEDY
    # per-request modality input, consumed ONCE at admission: vision patch
    # embeddings (1, n_img_tokens, d_model) -> cross-attn K/V rows, or audio
    # frame embeddings (1, enc_len, d_model) -> encoder pass -> wdec cross
    # K/V rows (transformer.admit_slot); numpy or a tensor
    frontend: Optional[np.ndarray] = None


@dataclasses.dataclass
class RequestOutput:
    """Typed generation result.

    finish_reason  "stop"   — a ``stop_token_ids`` member was sampled (it
                              is the last entry of ``token_ids``);
                   "length" — the max_new_tokens / max_len budget ran out.
    logprobs       per-token log-probabilities; None unless requested.
    ttft_s/tpot_s  joined from ServingMetrics at finish time.
    """
    request_id: int
    token_ids: list
    finish_reason: str               # "stop" | "length" | cancel's reason
    prompt_len: int = 0
    logprobs: Optional[list] = None
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None

    @property
    def n_tokens(self) -> int:
        return len(self.token_ids)


@dataclasses.dataclass
class _ReqState:
    """Engine-internal mutable generation state for one in-flight request
    (quacks like the scheduler's request protocol)."""
    req: Request
    seed: int                        # effective seed (params.seed or req.id)
    stop_ids: frozenset
    out_tokens: list = dataclasses.field(default_factory=list)
    logprobs: Optional[list] = None  # [] iff params.logprobs else None
    _sched_seq: Optional[int] = None   # set by RequestScheduler (FCFS order)
    _charged_footprint: Optional[int] = None   # budget charge at admission

    @property
    def id(self) -> int:
        return self.req.id

    @property
    def prompt(self) -> np.ndarray:
        return self.req.prompt

    @property
    def max_new_tokens(self) -> int:
        return self.req.max_new_tokens

    @property
    def priority(self) -> int:
        return self.req.priority

    @property
    def sampling(self) -> SamplingParams:
        return self.req.sampling

    def context(self) -> np.ndarray:
        """prompt + generated-so-far — what a (re-)prefill must cover."""
        if not self.out_tokens:
            return np.asarray(self.req.prompt, np.int32)
        return np.concatenate([np.asarray(self.req.prompt, np.int32),
                               np.asarray(self.out_tokens, np.int32)])


@dataclasses.dataclass
class _Slot:
    idx: int = 0                     # engine slot index (batch row)
    req: Optional[_ReqState] = None
    state: str = "idle"              # idle | prefill | decode
    pos: int = 0                     # tokens currently resident in the cache
    prefill_pos: int = 0             # context tokens already prefilled

    @property
    def busy(self) -> bool:
        return self.req is not None


class ContinuousBatchingEngine:
    def __init__(self, arch: ArchConfig, params, mesh=None, *, device=None,
                 slots: int = 4, max_len: int = 512,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 64,
                 share_prefix: bool = False,
                 scheduler: Optional[RequestScheduler] = None,
                 asa: Optional[AdaptiveScheduler] = None,
                 metrics: Optional[ServingMetrics] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 on_token: Optional[Callable[[int, int], None]] = None,
                 tracer=None, snapshot=None,
                 step_monitor: Optional[StepMonitor] = None,
                 sanitizer=None):
        """``params``: the nested param dict (``transformer.init_lm`` or a
        converted JAX pytree, the same on every rank of ``mesh``); leaves
        not yet on the engine's device are moved there.  ``mesh``: a
        ``DeviceMesh`` to place the params and pools on, whose device the
        engine runs on; without one, ``device``, which defaults to CUDA and
        raises when there is none.  ``asa``: the scheduler that plans the
        placement."""
        B.check_arch(arch)             # precise error for unported archs
        self.arch, self.mesh = arch, mesh
        if mesh is None:
            self.device = _device.resolve(device)
        else:
            self.device = mesh_device(mesh)
            if device is not None and \
                    _device.resolve(device).type != self.device.type:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"({self.device})")
        self.max_len, self.prefill_chunk = max_len, prefill_chunk
        self.share_prefix = share_prefix
        self._clock = clock
        self.on_token = on_token
        self._asa, self._slots = asa, slots
        self._plan = None if mesh is None else self._make_plan()
        max_blocks_per_seq = blocks_for(max_len, block_size)
        if num_blocks is None:
            num_blocks = slots * max_blocks_per_seq + 1   # +1: null block
        self.cache = UnifiedCacheManager(
            arch, PagedCacheConfig(block_size, num_blocks, max_blocks_per_seq,
                                   slots=slots, share_prefix=share_prefix),
            device=self.device, dtype=T.compute_dtype(arch), mesh=mesh,
            specs=None if mesh is None else self._plan.paged_cache_specs())
        params = _to_device(params, self.device)
        self._placed = None
        if mesh is None:
            self.params = params
        else:
            self._placed = Placement(arch, mesh, params, self.cache.pools,
                                     self._plan.param_specs(),
                                     self._plan.paged_cache_specs())
            self.params = self._placed.params
        del params
        block_fns = None if self._placed is None else self._placed.block_fns
        sampler = make_sampler(arch.vocab)
        self._prefill = ST.make_paged_prefill_step(arch, sampler=sampler,
                                                   block_fns=block_fns)
        self._decode = ST.make_paged_decode_step(arch, sampler=sampler,
                                                 block_fns=block_fns)
        self._admit_slot_state = (ST.make_slot_admit_step(
            arch, block_fns=block_fns) if self.cache.has_slot_state else None)
        self.scheduler = scheduler or RequestScheduler()
        # the engine truncates every request to max_len, so the token budget
        # charges capped footprints (the engine owns the cap)
        self.scheduler.footprint_cap = self.max_len
        self.metrics = metrics or ServingMetrics()
        # observability: the tracer and snapshot writer cost nothing when
        # absent; the StepMonitor always runs (a handful of floats)
        self.tracer = tracer
        self.snapshot = snapshot
        self.step_monitor = step_monitor or StepMonitor()
        self.metrics.scheduler_stats = self.scheduler.stats
        self.metrics.cache_stats = self.cache.stats
        # paged-cache sanitizer: explicit, or for a whole run through
        # REPRO_SANITIZE=1; imported only when one is wanted
        if sanitizer is None and os.environ.get("REPRO_SANITIZE"):
            from repro_torch.analysis.sanitizer import CacheSanitizer
            sanitizer = CacheSanitizer()
        self.sanitizer = sanitizer
        if self.sanitizer is not None:
            self.sanitizer.attach(self.cache)
        self.slots = [_Slot(idx=i) for i in range(slots)]
        self.completed: list[RequestOutput] = []
        self._states: dict[int, _ReqState] = {}   # queued or running

    def _make_plan(self):
        shape = ShapeSpec("serve", self.max_len, self._slots, "decode")
        mesh = (MeshShape(1, 1) if self.mesh is None
                else mesh_shape_of(self.mesh))
        return (self._asa or AdaptiveScheduler(faithful=False)).plan(
            self.arch, shape, mesh)

    @property
    def plan(self):
        """The ASA plan (``core.asa.SchedulePlan``) the engine is placed
        by: made at construction with a mesh, at first read without."""
        if self._plan is None:
            self._plan = self._make_plan()
        return self._plan

    def _model(self):
        """(params, pools) as the steps take them: the engine's own trees,
        or a placed engine's working params and local pool shards."""
        if self._placed is None:
            return self.params, self.cache.pools
        return self._placed.step_params(), self._placed.step_pools

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        """Every reject-at-submit check, with NO state change."""
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.id} has an empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.id}: max_new_tokens must be "
                             f">= 1 (got {req.max_new_tokens})")
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt ({len(req.prompt)}) >= max_len")
        if req.id in self._states:
            raise ValueError(f"request id {req.id} is already in flight")
        try:
            req.sampling.validate(self.arch.vocab)
        except ValueError as e:
            raise ValueError(f"request {req.id}: {e}") from None
        if blocks_for(self._target_total(req), self.cache.cfg.block_size) \
                > self.cache.cfg.num_blocks - 1:
            raise ValueError(f"request {req.id} can never fit the block pool")
        self.scheduler.check_submittable(req)

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        self._validate(req)
        sp = req.sampling
        st = _ReqState(
            req=req,
            # the effective seed depends only on the request, never on
            # scheduling: preemption re-derives the same keys
            seed=(sp.seed if sp.seed is not None else req.id % (2 ** 32)),
            stop_ids=frozenset(sp.stop_token_ids),
            logprobs=[] if sp.logprobs else None)
        self.scheduler.submit(st)        # may raise (token budget) — only a
        self._states[req.id] = st        # queued request claims its id
        t = self._clock() if now is None else now
        self.metrics.on_submit(req.id, t, prompt_len=len(req.prompt))
        if self.tracer is not None:
            self.tracer.request_begin(req.id, t, prompt_len=len(req.prompt),
                                      max_new_tokens=req.max_new_tokens,
                                      priority=req.priority)

    def _target_total(self, req) -> int:
        return min(len(req.prompt) + req.max_new_tokens, self.max_len)

    # ------------------------------------------------------------------
    @staticmethod
    def _sampling_rows(states: Sequence[Optional[_ReqState]]):
        """Per-row (temperature, top_k, top_p, seeds) host arrays for a
        batch of request states; None rows get greedy params and are
        discarded by the caller.  The sampler moves them to the device only
        when a row is stochastic."""
        n = len(states)
        temp = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        top_p = np.ones((n,), np.float32)
        seeds = np.zeros((n,), np.uint32)
        for i, st in enumerate(states):
            if st is None:
                continue
            sp = st.sampling
            temp[i], top_k[i], top_p[i] = sp.temperature, sp.top_k, sp.top_p
            seeds[i] = st.seed
        return temp, top_k, top_p, seeds

    def _record_token(self, slot: _Slot, tok: int, logp: float) \
            -> Optional[str]:
        """Append one sampled token and return its finish reason, if any
        ("stop" wins when a stop token lands exactly on the budget)."""
        st = slot.req
        st.out_tokens.append(tok)
        if st.logprobs is not None:
            st.logprobs.append(logp)
        if self.on_token is not None:
            self.on_token(st.id, tok)
        if tok in st.stop_ids:
            return "stop"
        if len(st.req.prompt) + len(st.out_tokens) >= self._target_total(st):
            return "length"
        return None

    def _finish(self, slot: _Slot, reason: str) -> None:
        st = slot.req
        self.cache.release(st.id)
        self.scheduler.on_finish(st)
        del self._states[st.id]
        self._complete(st, reason)
        slot.req, slot.state, slot.pos, slot.prefill_pos = None, "idle", 0, 0

    def _complete(self, st: _ReqState, reason: str) -> None:
        """Finish bookkeeping shared by ``_finish`` and a queued request's
        ``cancel``: metrics, trace and the RequestOutput."""
        t = self._clock()
        self.metrics.on_finish(st.id, len(st.out_tokens), t, reason=reason)
        if self.tracer is not None:
            self.tracer.request_end(st.id, t, finish_reason=reason,
                                    n_tokens=len(st.out_tokens))
        rep = self.metrics.request_report(st.id)
        self.completed.append(RequestOutput(
            request_id=st.id, token_ids=list(st.out_tokens),
            finish_reason=reason, prompt_len=len(st.req.prompt),
            logprobs=None if st.logprobs is None else list(st.logprobs),
            ttft_s=rep["ttft_s"], tpot_s=rep["tpot_s"]))

    def _preempt(self, slot: _Slot) -> None:
        st = slot.req
        self.cache.release(st.id)
        self.scheduler.preempt(st)
        self.metrics.on_preempt(st.id)
        if self.tracer is not None:
            self.tracer.request_instant(st.id, "preempt", self._clock(),
                                        resident_tokens=slot.pos,
                                        n_generated=len(st.out_tokens))
        slot.req, slot.state, slot.pos, slot.prefill_pos = None, "idle", 0, 0

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Abort a queued or running request; True iff ``rid`` was in
        flight.  It finishes with ``finish_reason=reason`` and the tokens it
        had produced.  A running request gives back its blocks and budget
        charge through ``_finish``; a queued one holds neither (the budget
        is charged at admission) and leaves the queue."""
        st = self._states.get(rid)
        if st is None:
            return False
        for slot in self.slots:
            if slot.req is st:
                self._finish(slot, reason)
                return True
        if not self.scheduler.remove(st):
            raise RuntimeError(f"request {rid} tracked but neither running "
                               f"nor queued — lifecycle invariant broken")
        del self._states[rid]
        self._complete(st, reason)
        return True

    def outstanding_tokens(self) -> int:
        """Worst-case tokens still to be generated across every queued and
        running request."""
        return sum(
            max(self._target_total(st) - len(st.req.prompt)
                - len(st.out_tokens), 0)
            for st in self._states.values())

    # -- phase 1: admission --------------------------------------------
    def _admit(self) -> int:
        admitted = 0
        for slot in self.slots:
            if slot.busy:
                continue
            head = self.scheduler.peek()
            if head is None:
                break
            ctx = head.context()
            if not self.cache.can_fit_request(ctx):
                if not any(s.busy for s in self.slots):
                    raise RuntimeError(
                        f"request {head.id} cannot fit an empty pool")
                break                      # wait for running requests to free
            st = self.scheduler.next_admission()
            if st is None:                 # token budget exhausted
                break
            if self.share_prefix:
                tp0 = self._clock()
                n_cached = self.cache.assign_prefix(st.id, ctx)
                tp1 = self._clock()
                self.metrics.on_phase("prefix_match", tp1 - tp0)
                if self.tracer is not None:
                    self.tracer.phase("prefix_match", tp0, tp1,
                                      request=st.id,
                                      matched_tokens=n_cached)
            else:
                n_cached = self.cache.assign_prefix(st.id, ctx)
            if not self.cache.reserve(st.id, len(ctx)):
                raise RuntimeError(
                    f"request {st.id}: can_fit_request passed but reserve "
                    f"failed — admission check out of sync with allocator")
            slot.req, slot.state = st, "prefill"
            slot.pos, slot.prefill_pos = n_cached, n_cached
            admitted += 1
            if self.share_prefix:
                self.metrics.on_prefix_match(n_cached, len(ctx),
                                             now=self._clock())
            if self.tracer is not None:
                t = self._clock()
                if st.out_tokens:      # re-admission after preemption
                    self.tracer.request_instant(st.id, "resume", t,
                                                n_generated=len(st.out_tokens))
                self.tracer.request_instant(st.id, "admitted", t,
                                            slot=slot.idx,
                                            context_len=len(ctx),
                                            prefix_cached_tokens=n_cached)
            if self._admit_slot_state is not None:
                # reset this slot's state-pool rows (zero mamba2 state;
                # cross K/V from the request's frontend, computed once)
                params, pools = self._model()
                if self._placed is None:
                    self._admit_slot_state(params, pools, slot.idx,
                                           st.req.frontend)
                else:
                    self._placed.admit(self._admit_slot_state, params,
                                       slot.idx, st.req.frontend)
        return admitted

    def _slot_ids(self, rows: list[Optional[int]]) -> Optional[torch.Tensor]:
        """Pool rows of the batch rows (None: the null slot), or None when
        the arch carries no slot state."""
        if not self.cache.has_slot_state:
            return None
        return self._tensor(self.cache.slot_ids_array(rows).astype(np.int64))

    # -- phase 2: one chunk of prefill ---------------------------------
    def _prefill_chunk(self) -> bool:
        # oldest request first (scheduler seq), not lowest slot index
        prefilling = [s for s in self.slots if s.state == "prefill"]
        if not prefilling:
            return False
        slot = min(prefilling, key=lambda s: s.req._sched_seq)
        st = slot.req
        ctx = st.context()
        chunk = ctx[slot.prefill_pos: slot.prefill_pos + self.prefill_chunk]
        n_new = len(chunk)
        if n_new < self.prefill_chunk:      # pad to the fixed chunk shape
            chunk = np.concatenate(
                [chunk, np.zeros(self.prefill_chunk - n_new, np.int32)])
        table = self.cache.table_array([st.id])
        tok, logp, _ = self._prefill(
            *self._model(), self._tensor(chunk[None, :]),
            self._tensor(np.asarray([slot.prefill_pos], np.int64)),
            self._tensor(table), self._tensor(np.asarray([n_new], np.int64)),
            self._slot_ids([slot.idx]), *self._sampling_rows([st]))
        slot.prefill_pos += n_new
        slot.pos = slot.prefill_pos
        self.cache.commit_prefix(st.id, ctx, slot.prefill_pos)
        self.metrics.prefill_chunks += 1
        if slot.prefill_pos == len(ctx):
            # the sampled token after the final chunk is the first output,
            # at absolute position len(ctx)
            t = self._clock()
            self.metrics.on_first_token(st.id, t)
            if self.tracer is not None:
                self.tracer.request_instant(st.id, "first_token", t)
            reason = self._record_token(slot, int(tok[0]), float(logp[0]))
            if reason is not None:
                self._finish(slot, reason)
            else:
                slot.state = "decode"
        return True

    # -- phase 3: one decode step for every decoding slot --------------
    def _decode_step(self) -> int:
        decoding = [s for s in self.slots if s.state == "decode"]
        if not decoding:
            return 0
        # grow block tables; preempt the largest footprint on pressure
        for slot in list(decoding):
            if slot.req is None:       # already preempted as an earlier victim
                continue
            while not self.cache.reserve(slot.req.id, slot.pos + 1):
                victims = [s.req for s in self.slots if s.busy]
                victim = self.scheduler.pick_preemption_victim(victims)
                vslot = next(s for s in self.slots if s.req is victim)
                self._preempt(vslot)
                if vslot in decoding:
                    decoding.remove(vslot)
                if slot.req is None:       # we preempted ourselves
                    break
        decoding = [s for s in decoding if s.req is not None]
        if not decoding:
            return 0
        n = len(self.slots)
        last = np.zeros((n, 1), np.int64)
        pos = np.zeros((n,), np.int64)
        rids: list[Optional[int]] = [None] * n
        for i, s in enumerate(self.slots):
            if s.state == "decode":
                last[i, 0] = s.req.out_tokens[-1]
                pos[i] = s.pos
                rids[i] = s.req.id
        table = self.cache.table_array(rids)
        # idle/prefilling rows scatter their slot state into the null row;
        # active rows use s.idx (the row admission reset and prefill filled)
        sids = self._slot_ids([s.idx if s.state == "decode" else None
                               for s in self.slots])
        tok, logp, _ = self._decode(
            *self._model(), self._tensor(last),
            self._tensor(pos), self._tensor(table), sids,
            *self._sampling_rows([s.req if s.state == "decode" else None
                                  for s in self.slots]))
        # the (B,) token/logprob copy is where the host waits for the device
        ts0 = self._clock()
        nxt = tok.cpu().numpy()
        lps = logp.cpu().numpy()
        ts1 = self._clock()
        self.metrics.on_phase("sample_sync", ts1 - ts0)
        if self.tracer is not None:
            n_sampled = sum(1 for s in decoding
                            if not s.req.sampling.is_greedy)
            self.tracer.phase("sample_sync", ts0, ts1,
                              n_rows=len(decoding), n_sampled=n_sampled)
        self.metrics.decode_steps += 1
        for i, s in enumerate(self.slots):
            if s.state != "decode":
                continue
            s.pos += 1
            reason = self._record_token(s, int(nxt[i]), float(lps[i]))
            if self.share_prefix and s.pos % self.cache.cfg.block_size == 0:
                # a block just filled: generated tokens extend the chain too
                self.cache.commit_prefix(s.req.id, s.req.context(), s.pos)
            if reason is not None:
                self._finish(s, reason)
        return len(decoding)

    # ------------------------------------------------------------------
    def step(self) -> None:
        tr = self.tracer
        t0 = self._clock()
        admitted = self._admit()
        t1 = self._clock()
        prefilled = self._prefill_chunk()
        t2 = self._clock()
        decoded = self._decode_step()
        t3 = self._clock()
        # phase durations only when the phase did work
        if admitted:
            self.metrics.on_phase("admission", t1 - t0)
            if tr is not None:
                tr.phase("admission", t0, t1, admitted=admitted)
        if prefilled:
            self.metrics.on_phase("prefill", t2 - t1)
            if tr is not None:
                tr.phase("prefill", t1, t2)
        if decoded:
            self.metrics.on_phase("decode", t3 - t2)
            if tr is not None:
                tr.phase("decode", t2, t3, n_rows=decoded)
        util = self.cache.utilization
        if tr is not None:
            tr.counter("queue_depth", t3, self.scheduler.queue_depth)
            tr.counter("block_utilization", t3, util)
        self.metrics.on_step(self.scheduler.queue_depth,
                             sum(s.busy for s in self.slots), len(self.slots),
                             block_utilization=util, now=t3)
        dur = t3 - t0
        triggered = self.step_monitor.update(dur)
        self.metrics.on_step_time(dur, ema=self.step_monitor.ema,
                                  drift=self.step_monitor.drift_fraction(),
                                  triggered=triggered)
        if self.snapshot is not None:
            self.snapshot.maybe_write(self.metrics, t3)
        if self.sanitizer is not None:
            self.sanitizer.check_engine_step(self)

    @property
    def has_work(self) -> bool:
        return self.scheduler.queue_depth > 0 or any(s.busy for s in self.slots)

    def _progress_marker(self) -> tuple:
        return (self.metrics.prefill_chunks, self.metrics.decode_steps,
                self.metrics.preemptions, len(self.completed),
                self.scheduler.queue_depth,
                sum(s.busy for s in self.slots))

    def run_until_drained(self, *, max_idle_steps: int = 1000) -> float:
        """Step until no queued or running work remains; raises after
        ``max_idle_steps`` consecutive steps without progress."""
        t0 = self._clock()
        idle, marker = 0, self._progress_marker()
        while self.has_work:
            self.step()
            now = self._progress_marker()
            idle = idle + 1 if now == marker else 0
            marker = now
            if idle >= max_idle_steps:
                raise RuntimeError(
                    f"engine made no progress for {idle} consecutive steps "
                    f"({self.scheduler.queue_depth} queued, "
                    f"{sum(s.busy for s in self.slots)} busy slots) — "
                    f"admission is wedged")
        if self.sanitizer is not None:
            self.sanitizer.check_drained(self)
        return self._clock() - t0

    # -- entry points ---------------------------------------------------
    def generate(self, requests: Iterable[Request]) -> list[RequestOutput]:
        """Submit every request, run until drained, and return their
        outputs in the order given.  The whole batch is validated before
        any request is submitted."""
        reqs = list(requests)
        seen: set[int] = set()
        for r in reqs:
            self._validate(r)
            if r.id in seen:
                raise ValueError(f"request id {r.id} appears twice in the "
                                 f"batch")
            seen.add(r.id)
        for r in reqs:
            self.submit(r)
        self.run_until_drained()
        by_id = {o.request_id: o for o in self.completed}  # latest id wins
        return [by_id[r.id] for r in reqs]

    def stream(self, requests: Iterable[Request]) \
            -> Iterator[tuple[int, int]]:
        """Submit every request (eagerly) and step the engine as the
        returned iterator is consumed, yielding ``(request_id, token_id)``
        pairs in sampling order."""
        for r in requests:
            self.submit(r)

        def _drive() -> Iterator[tuple[int, int]]:
            buf: list[tuple[int, int]] = []
            prev = self.on_token

            def tap(rid: int, tok: int) -> None:
                if prev is not None:
                    prev(rid, tok)
                buf.append((rid, tok))

            self.on_token = tap
            try:
                while self.has_work:
                    self.step()
                    while buf:
                        yield buf.pop(0)
            finally:
                self.on_token = prev

        return _drive()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)

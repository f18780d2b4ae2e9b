"""Continuous-batching engine over paged KV and slot-state pools (twin of
``repro/serving/engine.py``), greedy decode on one device.

Requests and results are two typed objects: ``Request`` is input-only and
never mutated; ``RequestOutput`` carries token ids, ``finish_reason``
("stop" on a stop-token hit, "length" on the max_new_tokens / max_len
budget), optional logprobs, and TTFT/TPOT joined from ServingMetrics.

Entry points: ``submit()`` + ``step()``/``run_until_drained()``,
``generate(requests)`` for submit-and-drain, ``stream(requests)`` yielding
(request_id, token) pairs, and an ``on_token`` callback.

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
the greedy sampler is fused into them, so only a (B,) token vector comes
back to the host per step.  The port serves archs built of every block
kind of the reference's decoders — ``attn``, ``moe_attn``, ``mla``,
``mla_dense``, ``mamba2``, ``shared_attn``, ``cross_attn`` and ``wdec``
(serving/cache_manager.py owns both state classes; zamba2's shared
block pages its KV in a pool per application, MLA blocks page latent
(c_kv, k_rope) pools, cross_attn and wdec hold each request's cross K/V
in slot rows); ``enc_attn`` in a decoder raises ``ValueError`` and an
unknown kind ``NotImplementedError`` at construction.
Stochastic sampling (temperature > 0) is refused at submit.  Not ported
yet: the reference engine's ASA plan / mesh placement, Chrome tracer,
snapshot writer, StepMonitor and cache sanitizer, and ``cancel`` /
``outstanding_tokens`` (used by the serving cluster).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as ST
from repro_torch.serving.cache_manager import UnifiedCacheManager
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged_cache import PagedCacheConfig, blocks_for
from repro_torch.serving.sampling import GREEDY, SamplingParams, make_sampler
from repro_torch.serving.scheduler import RequestScheduler

# the steps' (temperature, top_k, top_p, seeds) rows: submit admits greedy
# requests only, so the engine passes none (stochastic sampling is unported)
_GREEDY_ROWS = (None, None, None, None)

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
    finish_reason: str               # "stop" | "length"
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
    def __init__(self, arch: ArchConfig, params, *, device=None,
                 slots: int = 4, max_len: int = 512,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 64,
                 share_prefix: bool = False,
                 scheduler: Optional[RequestScheduler] = None,
                 metrics: Optional[ServingMetrics] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 on_token: Optional[Callable[[int, int], None]] = None):
        """``params``: the nested param dict (``transformer.init_lm`` or a
        converted JAX pytree); leaves not yet on ``device`` are moved there.
        ``device`` defaults to CUDA and raises when there is none."""
        B.check_arch(arch)             # precise error for unported archs
        self.arch = arch
        self.device = _device.resolve(device)
        self.max_len, self.prefill_chunk = max_len, prefill_chunk
        self.share_prefix = share_prefix
        self._clock = clock
        self.on_token = on_token
        max_blocks_per_seq = blocks_for(max_len, block_size)
        if num_blocks is None:
            num_blocks = slots * max_blocks_per_seq + 1   # +1: null block
        self.cache = UnifiedCacheManager(
            arch, PagedCacheConfig(block_size, num_blocks, max_blocks_per_seq,
                                   slots=slots, share_prefix=share_prefix),
            device=self.device, dtype=T.compute_dtype(arch))
        self.params = _to_device(params, self.device)
        sampler = make_sampler(arch.vocab)
        self._prefill = ST.make_paged_prefill_step(arch, sampler=sampler)
        self._decode = ST.make_paged_decode_step(arch, sampler=sampler)
        self._admit_slot_state = (ST.make_slot_admit_step(arch)
                                  if self.cache.has_slot_state else None)
        self.scheduler = scheduler or RequestScheduler()
        # the engine truncates every request to max_len, so the token budget
        # charges capped footprints (the engine owns the cap)
        self.scheduler.footprint_cap = self.max_len
        self.metrics = metrics or ServingMetrics()
        self.metrics.scheduler_stats = self.scheduler.stats
        self.metrics.cache_stats = self.cache.stats
        self.slots = [_Slot(idx=i) for i in range(slots)]
        self.completed: list[RequestOutput] = []
        self._states: dict[int, _ReqState] = {}   # queued or running

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
        if not req.sampling.is_greedy:
            raise NotImplementedError(
                f"request {req.id}: temperature {req.sampling.temperature} "
                f"> 0 — stochastic sampling is not ported to repro_torch "
                f"yet; only greedy decode (temperature=0) is served")
        if blocks_for(self._target_total(req), self.cache.cfg.block_size) \
                > self.cache.cfg.num_blocks - 1:
            raise ValueError(f"request {req.id} can never fit the block pool")
        self.scheduler.check_submittable(req)

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        self._validate(req)
        sp = req.sampling
        st = _ReqState(req=req, stop_ids=frozenset(sp.stop_token_ids),
                       logprobs=[] if sp.logprobs else None)
        self.scheduler.submit(st)        # may raise (token budget) — only a
        self._states[req.id] = st        # queued request claims its id
        t = self._clock() if now is None else now
        self.metrics.on_submit(req.id, t, prompt_len=len(req.prompt))

    def _target_total(self, req) -> int:
        return min(len(req.prompt) + req.max_new_tokens, self.max_len)

    # ------------------------------------------------------------------
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
        self.metrics.on_finish(st.id, len(st.out_tokens), self._clock(),
                               reason=reason)
        del self._states[st.id]
        rep = self.metrics.request_report(st.id)
        self.completed.append(RequestOutput(
            request_id=st.id, token_ids=list(st.out_tokens),
            finish_reason=reason, prompt_len=len(st.req.prompt),
            logprobs=None if st.logprobs is None else list(st.logprobs),
            ttft_s=rep["ttft_s"], tpot_s=rep["tpot_s"]))
        slot.req, slot.state, slot.pos, slot.prefill_pos = None, "idle", 0, 0

    def _preempt(self, slot: _Slot) -> None:
        st = slot.req
        self.cache.release(st.id)
        self.scheduler.preempt(st)
        self.metrics.on_preempt(st.id)
        slot.req, slot.state, slot.pos, slot.prefill_pos = None, "idle", 0, 0

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
                self.metrics.on_phase("prefix_match", self._clock() - tp0)
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
            if self._admit_slot_state is not None:
                # reset this slot's state-pool rows (zero mamba2 state;
                # cross K/V from the request's frontend, computed once)
                self.cache.pools = self._admit_slot_state(
                    self.params, self.cache.pools, slot.idx,
                    st.req.frontend)
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
            self.params, self.cache.pools, self._tensor(chunk[None, :]),
            self._tensor(np.asarray([slot.prefill_pos], np.int64)),
            self._tensor(table), self._tensor(np.asarray([n_new], np.int64)),
            self._slot_ids([slot.idx]), *_GREEDY_ROWS)
        slot.prefill_pos += n_new
        slot.pos = slot.prefill_pos
        self.cache.commit_prefix(st.id, ctx, slot.prefill_pos)
        self.metrics.prefill_chunks += 1
        if slot.prefill_pos == len(ctx):
            # the sampled token after the final chunk is the first output
            self.metrics.on_first_token(st.id, self._clock())
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
            self.params, self.cache.pools, self._tensor(last),
            self._tensor(pos), self._tensor(table), sids, *_GREEDY_ROWS)
        # the (B,) token/logprob copy is where the host waits for the device
        ts0 = self._clock()
        nxt = tok.cpu().numpy()
        lps = logp.cpu().numpy()
        self.metrics.on_phase("sample_sync", self._clock() - ts0)
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
        if prefilled:
            self.metrics.on_phase("prefill", t2 - t1)
        if decoded:
            self.metrics.on_phase("decode", t3 - t2)
        self.metrics.on_step(self.scheduler.queue_depth,
                             sum(s.busy for s in self.slots), len(self.slots),
                             block_utilization=self.cache.utilization, now=t3)
        self.metrics.on_step_time(t3 - t0)

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

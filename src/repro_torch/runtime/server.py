"""DEPRECATED compatibility shim for the retired wave-synchronized Server
(twin of ``repro/runtime/server.py``).

``Server`` keeps the old API — ``submit(Request)`` then
``run_until_drained()``, with the caller's Request objects mutated in place
— and delegates every token to ``repro_torch.serving.engine.
ContinuousBatchingEngine``.  New code should construct the engine
directly: it has the v2 generation API (per-request ``SamplingParams``,
typed ``RequestOutput``, ``generate()``/``stream()``/``on_token``), the
request scheduler, per-request frontends and the serving metrics, none of
which fit the legacy interface.  The shim is greedy-only: the legacy
Request has no sampling field.  As the engine requires, max_new_tokens >=
1, prompts are non-empty and shorter than max_len, and in-flight ids are
unique.  ``mesh`` and ``scheduler`` are the engine's ``mesh`` and ``asa``,
and ``plan`` is its ASA plan, as in the reference.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.asa import AdaptiveScheduler
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.engine import Request as EngineRequest


@dataclasses.dataclass
class Request:
    """Legacy request shape (no priority / frontend / scheduler fields)."""
    id: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Thin delegate to ContinuousBatchingEngine keeping the wave-era API.

    Extra keyword arguments (device, block_size, num_blocks,
    prefill_chunk, ...) pass straight through to the engine.
    """

    def __init__(self, arch: ArchConfig, params, mesh=None, *,
                 slots: int = 4, max_len: int = 512,
                 scheduler: Optional[AdaptiveScheduler] = None,
                 **engine_kwargs):
        warnings.warn(
            "runtime.server.Server is a deprecated compatibility shim over "
            "repro_torch.serving.ContinuousBatchingEngine — the wave decode "
            "path has been removed; construct the engine directly",
            DeprecationWarning, stacklevel=2)
        self.arch, self.mesh = arch, mesh
        self.slots, self.max_len = slots, max_len
        self.engine = ContinuousBatchingEngine(
            arch, params, mesh, slots=slots, max_len=max_len, asa=scheduler,
            **engine_kwargs)
        self.completed: list[Request] = []
        self._submitted: dict[int, Request] = {}

    @property
    def params(self):
        return self.engine.params

    @property
    def plan(self):
        return self.engine.plan

    @property
    def decode_steps(self) -> int:
        return self.engine.metrics.decode_steps

    @property
    def waves(self) -> int:
        """Always 0 — wave scheduling no longer exists."""
        return 0

    def submit(self, req: Request) -> None:
        self.engine.submit(EngineRequest(
            id=req.id, prompt=np.asarray(req.prompt, np.int32),
            max_new_tokens=req.max_new_tokens))
        self._submitted[req.id] = req

    def run_until_drained(self) -> float:
        wall = self.engine.run_until_drained()
        # mirror the engine's RequestOutputs back onto the caller's legacy
        # objects: in-place mutation is the legacy contract
        for out in self.engine.completed:
            legacy = self._submitted.pop(out.request_id, None)
            if legacy is not None:
                legacy.out_tokens = list(out.token_ids)
                legacy.done = True
                self.completed.append(legacy)
        self.engine.completed.clear()
        return wall

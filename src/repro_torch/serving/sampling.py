"""Per-request sampling for the continuous-batching engine (twin of
``repro/serving/sampling.py``, greedy branch).

``SamplingParams``
    The per-request decode controls, validated once at ``engine.submit``.
    ``temperature=0`` (the default) is exact greedy argmax.  The port has
    only the greedy branch so far: the engine refuses ``temperature > 0``
    at submit (stochastic sampling, with its seeded position-keyed draws,
    is a later slice).

``make_sampler(vocab)``
    The batched sample function fused as the tail of the paged steps
    (runtime/steps.py): ``argmax(float32(logits[:, :vocab]))`` per row —
    the padded vocab columns never win — plus that token's log-probability
    under the row's softmax.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Optional

import numpy as np
import torch

__all__ = ["SamplingParams", "GREEDY", "make_sampler"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls, validated at ``engine.submit``.

    temperature    0.0 => exact greedy argmax (top_k/top_p/seed ignored).
    top_k          keep only the k highest logits (0 disables).
    top_p          nucleus mass (1.0 disables).
    seed           RNG seed for this request's token stream (None: derived
                   from the request id).
    stop_token_ids sampling any of these ids finishes the request with
                   ``finish_reason="stop"`` (the stop token is the last
                   entry of ``RequestOutput.token_ids``).
    stop           stop *strings*, matched by a detokenizing frontend; the
                   engine itself never looks at them.
    logprobs       attach one logprob per generated token to the output.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop_token_ids: tuple = ()
    stop: tuple = ()
    logprobs: bool = False

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0

    def validate(self, vocab: Optional[int] = None) -> None:
        """Raise ValueError on any parameter a step can't honor.
        numbers.Integral/Real so numpy scalars are accepted."""
        t = self.temperature
        if not isinstance(t, numbers.Real) or t != t or t < 0 \
                or t == float("inf"):
            raise ValueError(f"temperature must be a finite float >= 0 "
                             f"(got {t!r})")
        if not isinstance(self.top_k, numbers.Integral) or self.top_k < 0:
            raise ValueError(f"top_k must be an int >= 0, 0 disabling the "
                             f"filter (got {self.top_k!r})")
        if vocab is not None and self.top_k > vocab:
            raise ValueError(f"top_k ({self.top_k}) exceeds the vocabulary "
                             f"({vocab})")
        p = self.top_p
        if not isinstance(p, numbers.Real) or not 0.0 < p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {p!r})")
        if self.seed is not None \
                and not (isinstance(self.seed, numbers.Integral)
                         and 0 <= self.seed < 2 ** 32):
            raise ValueError(f"seed must be None or an int in [0, 2**32) "
                             f"(got {self.seed!r})")
        for s in self.stop_token_ids:
            if not isinstance(s, numbers.Integral):
                raise ValueError(f"stop token id {s!r} is not an integer")
            if s < 0 or (vocab is not None and s >= vocab):
                raise ValueError(f"stop token id {int(s)} outside the "
                                 f"vocabulary [0, {vocab})")
        for s in self.stop:
            if not isinstance(s, str) or not s:
                raise ValueError(f"stop strings must be non-empty strings "
                                 f"(got {s!r})")


GREEDY = SamplingParams()


def make_sampler(vocab: int):
    """-> sample(logits (B, V'), temperature (B,), top_k (B,), top_p (B,),
    seeds (B,), positions (B,)) -> (tokens (B,) int64, logprobs (B,) f32)

    Greedy only: every row returns ``argmax(float32(logits[:, :vocab]))``
    (first index on ties, as the reference's argmax) and its logprob.  The
    per-row parameters are host (numpy) arrays, or None for all-greedy (the
    engine, which refuses temperature > 0 at submit, passes None); a row
    with temperature > 0 raises, since the stochastic branch is not
    ported."""
    def sample(logits, temperature, top_k, top_p, seeds, positions):
        if temperature is not None and np.any(np.asarray(temperature) > 0):
            raise NotImplementedError("stochastic sampling (temperature > 0) "
                                      "is not ported to repro_torch yet")
        lg = logits[:, :vocab].to(torch.float32)
        tok = torch.argmax(lg, dim=-1)
        logp = torch.gather(torch.log_softmax(lg, dim=-1), 1,
                            tok[:, None])[:, 0]
        return tok, logp

    return sample

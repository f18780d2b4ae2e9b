"""Per-request sampling for the continuous-batching engine (twin of
``repro/serving/sampling.py``).

``SamplingParams``
    The per-request decode controls, validated once at ``engine.submit``.
    ``temperature=0`` (the default) is exact greedy argmax.

``make_sampler(vocab)``
    The batched sample function fused as the tail of the paged steps
    (runtime/steps.py): every row carries its own (temperature, top_k,
    top_p, seed, position).  Greedy rows return ``argmax(float32(logits[:,
    :vocab]))`` (the padded vocab columns never win) and that token's
    log-probability under the row's softmax, bit for bit the greedy path
    the serving goldens pin.  Stochastic rows apply ``apply_top_k`` then
    ``apply_top_p`` to the tempered logits and draw one Gumbel-argmax
    sample with the key ``fold_in(PRNGKey(seed), position)``, JAX's
    threefry stream reproduced bit for bit (serving/threefry.py), so a
    seeded request gives the reference's tokens, and a recompute-preempted
    one regenerates its own.  The reference picks the branch on the device
    with ``lax.cond``; the port picks it on the host from the per-row
    arrays it is given, so an all-greedy batch pays no sort, no draw and
    no device sync.

Masking semantics (as the reference's):
  * top-k keeps the k highest-scoring tokens (ties at the k-th value are
    all kept); ``top_k=0`` disables the filter;
  * top-p keeps the smallest probability-sorted prefix whose cumulative
    mass reaches ``top_p`` (the exclusive mass before a token is < top_p),
    ties at the threshold all kept, never empty.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Optional

import numpy as np
import torch

from repro_torch.serving import threefry

__all__ = ["SamplingParams", "GREEDY", "make_sampler", "apply_top_k",
           "apply_top_p"]


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


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask all but the per-row ``top_k`` highest logits to -inf.

    ``logits`` (B, V) float; ``top_k`` (B,) int, 0 = keep everything.  The
    mask is a value threshold (the k-th largest value), so ties at the
    k-th value are all kept."""
    v = logits.shape[-1]
    k = torch.where(top_k > 0, top_k, v).to(torch.int64)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, (k - 1).clamp(0, v - 1)[:, None])
    return torch.where(logits >= kth, logits, float("-inf"))


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask: per row, keep the smallest probability-sorted prefix
    whose cumulative softmax mass reaches ``top_p`` (B,) in (0, 1]: sorted
    slot j is kept iff the mass strictly before it is < top_p, and every
    token whose probability reaches the last kept one's stays (ties at the
    threshold).  ``logits`` may already hold -inf from top-k."""
    probs = torch.softmax(logits, dim=-1)
    desc = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(desc, dim=-1)
    keep = (cum - desc) < top_p[:, None]
    thr = torch.where(keep, desc, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(probs >= thr, logits, float("-inf"))


def make_sampler(vocab: int):
    """-> sample(logits (B, V'), temperature (B,), top_k (B,), top_p (B,),
    seeds (B,), positions (B,)) -> (tokens (B,) int64, logprobs (B,) f32)

    ``temperature``, ``top_k``, ``top_p`` and ``seeds`` are host (numpy)
    rows, or None each for an all-greedy batch; ``positions`` is the
    absolute sequence position of the token being produced, a tensor on
    the logits' device.  Greedy rows (temperature 0) give
    ``argmax(float32(logits[:, :vocab]))`` (first index on ties, as the
    reference's argmax) and its logprob under the raw softmax.  When any
    row is stochastic, every row runs the stochastic math (greedy rows at
    t = 1, their result discarded) and stochastic rows take ``argmax(masked
    + gumbel)`` and their logprob under the masked distribution.  A
    stochastic row with no seed, or a top_k past the vocabulary, raises."""
    def sample(logits, temperature, top_k, top_p, seeds, positions):
        lg = logits[:, :vocab].to(torch.float32)
        greedy = torch.argmax(lg, dim=-1)
        raw = torch.log_softmax(lg, dim=-1)
        stoch = (np.zeros(len(lg), bool) if temperature is None
                 else np.asarray(temperature) > 0)
        if not stoch.any():
            return greedy, torch.gather(raw, 1, greedy[:, None])[:, 0]
        if seeds is None or top_k is None or top_p is None:
            raise ValueError("stochastic rows need top_k, top_p and seeds")
        if np.any(np.asarray(top_k) > vocab):
            raise ValueError(f"top_k {np.asarray(top_k).max()} exceeds the "
                             f"vocabulary ({vocab})")
        dev = lg.device
        rows = torch.as_tensor(stoch, device=dev)
        t = torch.as_tensor(np.where(stoch, temperature, 1.0)
                            .astype(np.float32), device=dev)
        masked = apply_top_p(
            apply_top_k(lg / t[:, None],
                        torch.as_tensor(np.asarray(top_k, np.int64),
                                        device=dev)),
            torch.as_tensor(np.asarray(top_p, np.float32), device=dev))
        noise = threefry.gumbel(
            torch.as_tensor(np.asarray(seeds, np.int64), device=dev),
            positions, vocab)
        tok = torch.where(rows, torch.argmax(masked + noise, dim=-1), greedy)
        dist = torch.where(rows[:, None], torch.log_softmax(masked, dim=-1),
                           raw)
        return tok, torch.gather(dist, 1, tok[:, None])[:, 0]

    return sample

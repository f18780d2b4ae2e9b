"""Input pipeline (the part of ``repro/data/pipeline.py`` the port's
training step needs, copied: it is numpy only, and the port imports
nothing of the JAX package)."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM batches: Zipf-ish token stream with
    next-token labels.  step-indexed => restartable from any offset.
    The same ``(seed, step)`` gives the same numpy batch as the reference's
    ``SyntheticLM``."""

    def __init__(self, vocab: int, seq_len: int, batch: int, *,
                 seed: int = 0, start_step: int = 0):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed
        self.step = start_step

    def skip(self, n: int):
        self.step += n
        return self

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        # zipf-flavored distribution over the real vocab
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

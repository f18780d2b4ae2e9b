"""Input pipeline (the parts of ``repro/data/pipeline.py`` the port's
training needs, copied: they are numpy and the standard library only, and
the port imports nothing of the JAX package): the deterministic synthetic
LM source, the paper's CIFAR-100-like images, host-sharded loading with
straggler-aware shard reassignment, and a background prefetch queue."""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

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


class SyntheticImages:
    """CIFAR-100-like labeled images (paper's dataset, synthesized):
    class-conditional gaussian blobs so accuracy is learnable.  The same
    ``(seed, step)`` gives the same numpy batch as the reference's
    ``SyntheticImages``: NHWC float32 images, int32 labels."""

    def __init__(self, n_classes: int = 100, image_size: int = 32,
                 batch: int = 128, *, seed: int = 0, start_step: int = 0):
        self.n_classes, self.image_size, self.batch = n_classes, image_size, batch
        self.seed, self.step = seed, start_step
        rng = np.random.default_rng(seed)
        self.class_means = rng.normal(0, 1.0, (n_classes, 8)).astype(np.float32)

    def skip(self, n: int):
        self.step += n
        return self

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step + 1))
        labels = rng.integers(0, self.n_classes, self.batch).astype(np.int32)
        base = self.class_means[labels]                        # (B, 8)
        proj = np.random.default_rng(self.seed + 7).normal(
            0, 1, (8, self.image_size * self.image_size * 3)).astype(np.float32)
        imgs = (base @ proj).reshape(self.batch, self.image_size,
                                     self.image_size, 3)
        imgs += rng.normal(0, 0.7, imgs.shape).astype(np.float32)
        self.step += 1
        return {"images": imgs.astype(np.float32), "labels": labels}


class HostShardedLoader:
    """Splits the global batch across hosts; reassigns shards away from
    hosts whose heartbeats go stale (straggler mitigation, DESIGN.md §7)."""

    def __init__(self, source_factory: Callable[[int, int], Iterator[dict]],
                 n_hosts: int, host_id: int, *,
                 heartbeat_timeout_s: float = 30.0):
        self.n_hosts, self.host_id = n_hosts, host_id
        self.timeout = heartbeat_timeout_s
        self.heartbeats = {h: time.monotonic() for h in range(n_hosts)}
        self._factory = source_factory
        self._build()

    def _build(self):
        self.assigned = self._live_assignment()
        self.sources = {s: self._factory(s, self.n_hosts)
                        for s in self.assigned}

    def heartbeat(self, host: int, t: Optional[float] = None):
        self.heartbeats[host] = t if t is not None else time.monotonic()

    def _live_assignment(self) -> list[int]:
        now = time.monotonic()
        live = [h for h in range(self.n_hosts)
                if now - self.heartbeats[h] <= self.timeout]
        if self.host_id not in live:
            return []
        idx = live.index(self.host_id)
        # dead hosts' shards are taken over round-robin by live hosts
        return [s for s in range(self.n_hosts) if s % len(live) == idx] \
            if len(live) < self.n_hosts else [self.host_id]

    def __next__(self) -> list[dict]:
        new = self._live_assignment()
        if new != self.assigned:
            self.assigned = new
            self.sources = {s: self._factory(s, self.n_hosts) for s in new}
        return [next(self.sources[s]) for s in self.assigned]


class Prefetcher:
    """Background-thread prefetch queue (overlap host input with device
    compute)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self.q.put(item)
            finally:
                self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

"""JAX's threefry RNG in torch integer ops: the Gumbel noise the stochastic
sampler draws (twin of what ``repro/serving/sampling.py`` calls,
``jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), position),
(vocab,), float32)``), bit for bit.

It follows JAX 0.9.0 as the reference engine runs it:
``jax_threefry_partitionable=True`` (random bits from the counter pairs
(0, i), ``bits1 ^ bits2``) and the "low" Gumbel mode (``-log(-log(u))``,
``use_high_dynamic_range_gumbel`` off).  The pieces, each from
``jax/_src``:

  ``threefry2x32``  the 20-round Threefry-2x32 cipher and its key
                    schedule (``prng.py`` ``_threefry2x32_lowering``);
  ``fold_in``       ``threefry_2x32(key, threefry_seed(data))`` with the
                    seed ``(0, data)`` (``prng.py`` ``_threefry_fold_in``);
  ``random_bits``   32-bit bits of a flat ``(n,)`` draw under the
                    partitionable flag (``prng.py``
                    ``_threefry_random_bits_partitionable``);
  ``uniform``       ``bits >> 9 | 0x3F800000`` bit-cast to float32, minus
                    1, scaled to ``[minval, 1)`` and floored at ``minval``
                    (``random.py`` ``_uniform``);
  ``gumbel``        ``-log(-log(uniform(tiny, 1)))`` (``random.py``
                    ``_gumbel``).

torch has no unsigned 32-bit arithmetic on CUDA and its ``>>`` on int32 is
arithmetic, so every uint32 lives in an int64 tensor, masked to 32 bits
after each add and each rotate.  A batch of rows is one tensor program:
keys are (B,) tensors, the draw is (B, n), with no loop over rows.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel"]

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 of the counter pairs (x0, x1) under the key (k1, k2):
    int64 tensors holding uint32 values, broadcast together.  -> (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seeds: torch.Tensor):
    """``jax.random.PRNGKey`` of uint32 seeds (B,) -> keys (0, seed)."""
    seeds = seeds.to(torch.int64) & MASK
    return torch.zeros_like(seeds), seeds


def fold_in(keys, data: torch.Tensor):
    """``jax.random.fold_in`` of (B,) keys with (B,) uint32 data."""
    data = data.to(torch.int64) & MASK
    return threefry2x32(keys[0], keys[1], torch.zeros_like(data), data)


def random_bits(keys, n: int) -> torch.Tensor:
    """(B, n) 32-bit random bits, ``jax.random.bits(key, (n,))`` per row."""
    k1, k2 = keys[0][:, None], keys[1][:, None]
    iota = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(iota), iota)
    return b1 ^ b2


def uniform(keys, n: int, minval: float = 0.0) -> torch.Tensor:
    """(B, n) float32 uniforms in [minval, 1), ``jax.random.uniform(key,
    (n,), minval=minval, maxval=1.)`` per row."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(1.0) - lo            # maxval - minval, in float32
    return torch.clamp_min(floats * float(scale) + float(lo), float(lo))


def gumbel(seeds: torch.Tensor, positions: torch.Tensor, n: int) \
        -> torch.Tensor:
    """(B, n) float32 Gumbel noise of row b drawn with the key
    ``fold_in(PRNGKey(seeds[b]), positions[b])``: the sampler's draw."""
    keys = fold_in(prng_key(seeds), positions)
    return -torch.log(-torch.log(uniform(keys, n, TINY)))

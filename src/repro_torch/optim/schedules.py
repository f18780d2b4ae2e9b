"""LR schedules (twin of ``repro/optim/schedules.py``): functions of an
integer step that return the reference's fp32 value, bit for bit, as a
Python float.  Each step of the arithmetic is one fp32 operation in the
reference's order (numpy float32 scalars), the constants rounded to fp32
as JAX rounds its weakly typed Python scalars.  The cosine is the C
library's ``cosf``, which is what XLA's fp32 cosine computes on the host;
numpy's and torch's fp32 cosines differ from it in the last bit."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np

f32 = np.float32


@functools.cache
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cos(x: np.float32) -> np.float32:
    return f32(_libm_cosf()(float(x)))


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step: int) -> float:
        ratio = np.minimum(f32(1.0), f32(step) / f32(max(warmup_steps, 1)))
        return float(f32(peak_lr) * ratio)
    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    def fn(step: int) -> float:
        t = f32(step)
        warm = t / f32(max(warmup_steps, 1))
        prog = np.clip((t - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (
            f32(1.0) + _cos(f32(math.pi) * prog))
        return float(f32(peak_lr) * (warm if t < f32(warmup_steps) else cos))
    return fn

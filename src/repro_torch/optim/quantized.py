"""Int8 optimizer-state quantization (blockwise absmax, Adam moments at
1 byte each), twin of ``repro/optim/quantized.py`` — the memory trick that
fits 480B/671B-param training states on a 256-chip pod.

Each moment leaf becomes a ``QLeaf``: int8 codes (n_blocks, 256) of the
leaf flattened and zero-padded to whole blocks, and fp32 per-block
scales (n_blocks, 1); shape and sign are static.  Each operation is the
reference's in fp32, in its order (``torch.round`` rounds half to even,
as ``jnp.round``), so the codes equal the reference's.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import tree

BLOCK = 256


class QLeaf:
    def __init__(self, q, scale, shape, signed):
        self.q = q              # int8 (n_blocks, BLOCK)
        self.scale = scale      # fp32 (n_blocks, 1)
        self.shape = tuple(shape)
        self.signed = bool(signed)

    @classmethod
    def from_dense(cls, x: torch.Tensor, signed: bool) -> "QLeaf":
        flat = x.to(torch.float32).reshape(-1)
        pad = (-flat.numel()) % BLOCK
        flat = torch.nn.functional.pad(flat, (0, pad))
        blocks = flat.reshape(-1, BLOCK)
        absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True) + 1e-12
        if signed:
            q = torch.clamp(torch.round(blocks / absmax * 127), -127, 127)
        else:
            q = torch.clamp(torch.round(blocks / absmax * 255) - 128,
                            -128, 127)
        return cls(q.to(torch.int8), absmax, x.shape, signed)

    def dense(self) -> torch.Tensor:
        if self.signed:
            blocks = self.q.to(torch.float32) / 127.0 * self.scale
        else:
            blocks = (self.q.to(torch.float32) + 128.0) / 255.0 * self.scale
        n = math.prod(self.shape) if self.shape else 1
        return blocks.reshape(-1)[:n].reshape(self.shape)


QuantizedMoments = Any  # a tree with QLeaf leaves


def quantize_moments(moments, *, signed: bool):
    return tree.map(lambda x: QLeaf.from_dense(x, signed), moments)


def dequantize_moments(moments):
    return tree.map(lambda q: q.dense(), moments)

"""Error-feedback gradient compression for slow (pod-axis) links (twin of
``repro/optim/compression.py``).

int8 quantization with residual error feedback: the de/re-quantization
error is carried in fp32 state and added back before the next
compression, so the compressed SGD trajectory tracks the exact one (Seide
et al. / EF-SGD).  Meant for the `pod` axis, the mesh's slowest link;
reductions over the other axes stay exact.

``compressed_allreduce`` does the reference's arithmetic: the mean over
the group of the *dequantized* fp32 grads (the reference's ``pmean`` of
``deq``), so what crosses the link is fp32, not the int8 codes.  Neither
package calls it from the train step.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.optim.quantized import QLeaf


def init_error_state(grads):
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress(grads, error_state):
    """-> (quantized grads: a tree of QLeaf, the corrected fp32 grads)."""
    corrected = tree.map(lambda g, e: g.to(torch.float32) + e, grads,
                         error_state)
    q = tree.map(lambda c: QLeaf.from_dense(c, signed=True), corrected)
    return q, corrected


def decompress_and_update_error(q, corrected):
    """-> (dequantized grads, new error residuals)."""
    deq = tree.map(lambda v: v.dense(), q)
    new_err = tree.map(lambda c, d: c - d, corrected, deq)
    return deq, new_err


def compressed_allreduce(grads, error_state, group=None):
    """Error-feedback compression, then the mean of the dequantized grads
    over the ranks of ``group`` (a mesh dim's process group, such as
    ``mesh.get_group("pod")``; None: the world).  -> (averaged fp32
    grads, new error state).  A collective: every rank of ``group`` calls
    it with trees of the same shapes."""
    q, corrected = compress(grads, error_state)
    deq, new_err = decompress_and_update_error(q, corrected)
    n = dist.get_world_size(group)

    def mean(d):
        dist.all_reduce(d, group=group)
        return d / n
    return tree.map(mean, deq), new_err

"""Optimizers (twin of ``repro/optim/optimizers.py``).

``adamw`` and ``sgd_momentum`` return ``(init, update)`` pairs.  State
mirrors the param tree: fp32 moments of each leaf's shape.  Each fp32
operation is the reference's, in its order, so a step agrees with it to
rounding.

The reference donates ``(params, opt_state)`` to the train step, so the
port works IN PLACE, leaf by leaf: ``clip_by_global_norm`` scales the fp32
grads where they lie, ``update`` advances the moments it was given and
writes each leaf's update into that leaf's fp32 grad (the grads are
consumed), and ``apply_updates`` writes the new values into the params.
Each leaf makes at most one fp32 temporary, freed before the next leaf.

``adamw(..., quantized=True)`` stores the moments int8 (``QLeaf``,
``optim/quantized.py``): 6 bytes a param in all instead of 16.  Each step
dequantizes a leaf's moments to fp32, advances them as above, and writes
them back requantized into the same ``QLeaf`` (its codes and scales
overwritten in place).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.optim.quantized import QLeaf, quantize_moments


class OptState(NamedTuple):
    step: int
    mu: Any          # first moment
    nu: Any          # second moment
    extra: Any = None


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum over leaves of sum(g^2)), in fp32 (a 0-d tensor)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales fp32 ``grads`` in place by min(1, max_norm / (norm + 1e-9))
    -> (grads, norm).  The reference's clipped grads are fp32 too (a bf16
    grad times its fp32 scale promotes)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in tree.leaves(grads):
        if g.dtype != torch.float32:
            raise ValueError(f"clip_by_global_norm scales fp32 grads in "
                             f"place, got {g.dtype}")
        g.mul_(scale)
    return grads, norm


def _f32_pow(b: float, t: int) -> float:
    """``b ** t`` in fp32, as the reference takes it."""
    return float(np.power(np.float32(b), np.float32(t)))


def adamw(lr: Callable | float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, quantized: bool = False):
    """AdamW with fp32 moments (int8 with ``quantized``) and bias
    correction by 1 - b^t.  ``lr`` is a float or a function of the integer
    step (``optim.schedules``)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        mu, nu = tree.map(zeros, params), tree.map(zeros, params)
        if quantized:
            mu = quantize_moments(mu, signed=True)
            nu = quantize_moments(nu, signed=False)
        return OptState(0, mu, nu)

    def moment(x):
        """The fp32 moment to advance in place: the leaf itself, or a
        leaf's dequantized copy."""
        return x.dense() if quantized else x

    def store(x, dense, signed):
        if quantized:
            new = QLeaf.from_dense(dense, signed)
            x.q.copy_(new.q)
            x.scale.copy_(new.scale)

    def update(grads, state: OptState, params):
        step = state.step + 1
        c1 = 1.0 - _f32_pow(b1, step)
        c2 = 1.0 - _f32_pow(b2, step)
        c1, c2 = float(np.float32(c1)), float(np.float32(c2))
        lr_t = lr_fn(step)
        updates = []
        for g, mq, vq, p in zip(tree.leaves(grads), tree.leaves(state.mu),
                                tree.leaves(state.nu), tree.leaves(params)):
            u = g.float()                     # the update's storage
            m, v = moment(mq), moment(vq)
            m.mul_(b1).add_(u, alpha=1 - b1)
            v.mul_(b2).addcmul_(u, u, value=1 - b2)
            denom = torch.div(v, c2).sqrt_().add_(eps)
            torch.div(m, c1, out=u).div_(denom)
            u.add_(p, alpha=weight_decay).mul_(-lr_t)
            store(mq, m, True)
            store(vq, v, False)
            updates.append(u)
        return (tree.unflatten(grads, updates),
                OptState(step, state.mu, state.nu))

    return init, update


def sgd_momentum(lr: Callable | float, *, momentum=0.9, weight_decay=0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params) -> OptState:
        return OptState(0, tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params), None)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        updates = []
        for g, m, p in zip(tree.leaves(grads), tree.leaves(state.mu),
                           tree.leaves(params)):
            u = g.float()                     # the update's storage
            m.mul_(momentum).add_(u).add_(p, alpha=weight_decay)
            updates.append(torch.mul(m, -lr_t, out=u))
        return tree.unflatten(grads, updates), OptState(step, state.mu, None)

    return init, update


def apply_updates(params, updates):
    """(p.float() + u).to(p.dtype) for every leaf, written into ``params``'
    own tensors; returns ``params``."""
    with torch.no_grad():
        for p, u in zip(tree.leaves(params), tree.leaves(updates)):
            p.copy_(p.float().add_(u))
    return params

"""Convert a JAX param or paged-cache pytree, given as numpy arrays, into the
port's torch tensors and back — leaf by leaf, keeping the nesting (dicts,
lists, tuples; the stacked segment ``repeat`` axis included) and the dtype.

The caller turns its JAX arrays into numpy first (e.g.
``jax.tree.map(np.asarray, params)``), so this module never imports JAX.
bfloat16 leaves arrive as numpy arrays of the ``ml_dtypes`` bfloat16
dtype; their bits are carried through a 16-bit integer view, so the
round trip is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)                 # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # only needed when bf16 leaves come back
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device="cpu"):
    """numpy pytree -> same nesting of torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def to_numpy(tree):
    """torch pytree -> same nesting of numpy arrays (bf16 leaves come back
    as ``ml_dtypes.bfloat16`` arrays, which JAX accepts)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)

"""Checkpointing: npz + json manifest (twin of ``repro/checkpoint/
store.py``, in the reference's layout, so that an fp32 checkpoint moves
between the two packages in both directions).

  * layout — ``arrays.npz`` holding leaf i as ``a{i}``, ``manifest.json``
    with the leaves' ``keys`` (the reference's path strings: dict keys,
    list indices, ``.field`` for a NamedTuple's fields, ``0`` / ``1`` for
    an int8 moment's codes and scales), ``time`` and the caller's extra
    fields (``step``, ``data_offset``).  numpy has no bfloat16 without
    JAX's ``ml_dtypes``, so a bf16 leaf is stored as its 16-bit pattern
    (a ``uint16`` array) and the manifest gains a ``dtypes`` list, one
    name a leaf, which the reference ignores.
  * atomic commit — write to ``<dir>.tmp``, then rename; a crash mid-save
    never corrupts the latest checkpoint
  * async save — the caller's state is copied to host memory first (a
    consistent cut), then a background thread writes it
  * keep-k GC
  * restore **with resharding** — each leaf lands as its like-tree leaf
    lies: a DTensor is re-placed on its mesh by its placements, each rank
    taking its own shard of the leaf it reads (``sharding.from_full``), so
    a checkpoint taken on one mesh restarts on another.  On several
    ranks, rank 0 writes the gathered leaves (``sharded.whole``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import time
import zipfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.quantized import QLeaf


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _flat_with_paths(t, path=()):
    """-> [(key, leaf)] in the reference's flattening order: dict keys
    sorted, list and tuple items in order, a NamedTuple's fields as
    ``.name``, a QLeaf's codes and scales as ``0`` and ``1``; None holds
    no leaf."""
    if t is None:
        return []
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat_with_paths(t[k],
                                                               path + (k,))]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return [x for f, v in zip(t._fields, t)
                for x in _flat_with_paths(v, path + (f".{f}",))]
    if isinstance(t, (list, tuple)):
        return [x for i, v in enumerate(t)
                for x in _flat_with_paths(v, path + (i,))]
    if isinstance(t, QLeaf):
        return [("/".join(map(str, path + (0,))), t.q),
                ("/".join(map(str, path + (1,))), t.scale)]
    return [("/".join(map(str, path)), t)]


def _rebuild(t, it):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _rebuild(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_rebuild(v, it) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, it) for v in t)
    if isinstance(t, QLeaf):
        return QLeaf(next(it), next(it), t.shape, t.signed)
    return next(it)


@dataclasses.dataclass
class _Host:
    """A leaf copied to host memory: the array to write and the name of
    the leaf's dtype."""
    array: np.ndarray
    dtype: str


def _to_host(x) -> _Host:
    """A leaf as a host numpy array (bf16 as its uint16 bit pattern) and
    its dtype's name.  A DTensor must have been gathered before."""
    if isinstance(x, _Host):
        return x
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)    # the cut: a copy, always
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy().view(np.uint16), name)
        return _Host(t.numpy(), name)
    a = np.asarray(x)
    return _Host(a, a.dtype.name)


def _gathered(x):
    """A DTensor's whole tensor (``sharded.whole``), else ``x``."""
    if not _is_dtensor(x):
        return x
    from repro_torch.runtime.sharded import whole
    return whole(x)


def save_pytree(path, tree, *, manifest_extra: Optional[dict] = None):
    """Write ``tree`` (tensors, DTensors already gathered, ints, numpy
    arrays) to ``path`` atomically."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = _flat_with_paths(tree)
    arrays, dtypes = {}, []
    for i, (_, v) in enumerate(flat):
        h = _to_host(v)
        arrays[f"a{i}"] = h.array
        dtypes.append(h.dtype)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"keys": [k for k, _ in flat], "time": time.time(),
                "dtypes": dtypes}
    manifest.update(manifest_extra or {})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)                       # atomic commit


def _as_tensor(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(_c_order(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(_c_order(a))


def _place(a: torch.Tensor, like):
    """``a`` (a full CPU tensor) in ``like``'s dtype, device and, for a
    DTensor, on its mesh by its placements."""
    if _is_dtensor(like):
        from repro_torch.core.sharding import from_full
        dev = torch.device(like.device_mesh.device_type,
                           torch.cuda.current_device()) \
            if like.device_mesh.device_type == "cuda" else torch.device("cpu")
        return from_full(a.to(device=dev, dtype=like.dtype),
                         like.device_mesh, like.placements)
    if isinstance(like, torch.Tensor):
        return a.to(device=like.device, dtype=like.dtype)
    if isinstance(like, int):
        return int(a)
    return a.numpy()


def _c_order(a: np.ndarray) -> np.ndarray:
    """``a`` in C order, 0-d kept 0-d (``np.ascontiguousarray`` makes it
    1-d)."""
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _npz_members(path: pathlib.Path):
    """-> get(name): the array ``name`` of an npz file.  A member stored
    uncompressed (``np.savez`` stores so) is read straight from its offset
    into the array's memory, past zipfile's chunked CRC-checked reads and
    numpy's chunk copies; a compressed one goes through ``np.load``."""
    with zipfile.ZipFile(path) as z:
        infos = {i.filename.removesuffix(".npy"): i for i in z.infolist()}

    def get(name: str) -> np.ndarray:
        info = infos[name]
        if info.compress_type != zipfile.ZIP_STORED:
            with np.load(path) as data:
                return data[name]
        with open(path, "rb") as f:
            f.seek(info.header_offset)
            local = f.read(30)                 # the member's local header
            n_name = int.from_bytes(local[26:28], "little")
            n_extra = int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0) else
                           np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            a = np.empty(shape, dtype, order="F" if fortran else "C")
            buf = memoryview(a.reshape(-1, order="A").view(np.uint8))
            if f.readinto(buf) != a.nbytes:
                raise OSError(f"{path}: member {name} is truncated")
        return a
    return get


def restore_pytree(path, like_tree):
    """Restore into the structure of ``like_tree``: each leaf in its
    like-leaf's dtype and device, a DTensor re-placed by its mesh and
    placements (reshard on restore) -> (tree, manifest)."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    get = _npz_members(path / "arrays.npz")
    flat = _flat_with_paths(like_tree)
    keys = [k for k, _ in flat]
    assert keys == manifest["keys"], "checkpoint/model structure mismatch"
    dtypes = manifest.get("dtypes") or [None] * len(keys)
    loaded = [_place(_as_tensor(get(f"a{i}"), dtypes[i]), like)
              for i, (_, like) in enumerate(flat)]
    return _rebuild(like_tree, iter(loaded)), manifest


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        """Join the writer; on several ranks, then meet every rank, so
        that none reads the directory before the write is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def save(self, step: int, tree, *, extra: Optional[dict] = None):
        """Gather every DTensor leaf (a collective: every rank calls
        this), copy the state to host memory on rank 0 (the consistent
        cut), and write it there in the background."""
        self.wait()
        flat = [(k, _gathered(v)) for k, v in _flat_with_paths(tree)]
        if _rank() != 0:
            return
        host = [_to_host(v) for _, v in flat]
        like = _rebuild(tree, iter(host))

        def work():
            save_pytree(self._step_dir(step), like,
                        manifest_extra={"step": step, **(extra or {})})
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, like_tree, *, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_pytree(self._step_dir(step), like_tree)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

"""HP on a multi-pod mesh and error-feedback gradient compression, on the
CPU.

Four gloo ranks (``torch_dist_worker.run_pod``), spawned once, train
tiny-rt under uniform HP on the (pod, data, model) meshes (2, 2, 1) and
(2, 1, 2), built with ``init_device_mesh``.  Each rank's shard of every
param (at init) and of every int8-moment leaf (after a step) is the block
that the reference's spec (``repro.core.sharding`` at ``MeshShape(d, m,
pod=2)``) gives its coordinates, JAX's way: the first axis of a shared
dim the major one, so the rank at (pod p, data d) of (2, 2, 1) holds block
``2 d + p`` of HP's ``("data", "pod")`` dim.  The fp32 and int8 losses and
step 1's gradients equal the single rank's at
``test_torch_distributed.py``'s tolerances; a checkpoint saved on the pod
mesh restores on (4, 1) bit for bit, and ``Trainer.resize`` onto (4, 1)
keeps every value; ``compressed_allreduce`` over the pod group gives the
mean of the reference's ``decompress_and_update_error`` outputs of the
group's ranks, and each rank's error state is the reference's.

In one process, ``tests/test_optim.py::
test_error_feedback_compression_converges`` re-pointed at the port: its
codes, scales and error state against the reference's, step by step.
"""
import dataclasses
import pathlib
import pickle
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro.configs import base as jbase
from repro.core import components as JC
from repro.core import sharding as JSH
from repro.core.costmodel import MeshShape as JMeshShape
from repro.core.strategy import Strategy as JStrategy
from repro.optim import compression as JEF
from repro.optim import optimizers as JO
from repro.optim.quantized import QLeaf as JQLeaf
from repro_torch.launch import mesh as M
from repro_torch.optim import compression as EF
from test_torch_distributed import TOL, _assert_single_rank_grads

AXES = ("pod", "data", "model")


@pytest.fixture(scope="module", autouse=True)
def _world_of_one():
    """The single-rank references run on a world of 1 in this process;
    torn down after the module (as in test_torch_distributed)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    M.shutdown()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pod_ranks():
    d = pathlib.Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    mp.start_processes(W.run_pod, args=(4, str(d / "store"),
                                        str(d / "out.pkl")),
                       nprocs=4, start_method="spawn")
    res = pickle.loads((d / "out.pkl").read_bytes())
    res["seconds"] = time.perf_counter() - t0
    return res


@pytest.fixture(scope="module")
def single_rank():
    arch = W.ARCHS[W.POD_ARCH]
    mesh = M.make_host_mesh(device="cpu")
    return dict(losses=W.train(arch, mesh, "DP")[3],
                int8=W.train(arch, mesh, "HP", quantized=True, steps=3)[3])


def _jax_arch(arch):
    """The reference's ArchConfig with every field of the port's."""
    kw = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)}
    kw["pattern"] = tuple(jbase.Segment(s.blocks, s.repeat)
                          for s in arch.pattern)
    return jbase.ArchConfig(**kw)


def _ref_specs(res, shape):
    """The reference's specs for the pod case ``shape`` (pod, data,
    model): its params' and its int8 moments' (codes, scales) in leaf
    order."""
    p, d, m = shape
    jarch = _jax_arch(W.ARCHS[W.POD_ARCH])
    jm = JMeshShape(d, m, pod=p)
    jasg = {k: JStrategy(v) for k, v in res["assignment"].items()}
    pspecs = JSH.param_specs(jarch, jasg, jm)
    jostate = jax.eval_shape(JO.adamw(1e-3, quantized=True)[0],
                             JC.abstract_params(jarch))
    ospecs = JSH.opt_state_specs(jostate, pspecs, jm)

    def leaves(t):
        return [tuple(x) for x in jax.tree.leaves(
            t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    flat = leaves(ospecs.mu) + leaves(ospecs.nu)
    return leaves(pspecs), list(zip(flat[0::2], flat[1::2]))


def _jax_block(full, spec, sizes, coords):
    """The block of ``full`` that JAX's ``NamedSharding(mesh, spec)``
    gives the device at ``coords``: along each dim, the axes' mixed-radix
    index with the first axis the major one."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        k, n = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        size = full.shape[d] // n
        full = np.take(full, range(k * size, (k + 1) * size), axis=d)
    return full


def test_pod_spawn_is_as_cheap(pod_ranks):
    assert pod_ranks["seconds"] < 120


@pytest.mark.parametrize("shape", W.POD_MESHES)
def test_shards_are_the_references_blocks(pod_ranks, shape):
    res = pod_ranks[shape]
    pspecs, qspecs = _ref_specs(res, shape)
    sizes = dict(zip(AXES, shape))
    assert len(pspecs) == len(res["params_full"])
    strided = False
    for r, c in enumerate(res["coords"]):
        coords = dict(zip(AXES, c))
        for i, (full, spec) in enumerate(zip(res["params_full"], pspecs)):
            want = _jax_block(full, spec, sizes, coords)
            np.testing.assert_array_equal(res["params_local"][r][i], want,
                                          err_msg=f"{res['names'][i]} {c}")
            strided |= any(isinstance(ax, tuple) and ax[0] == "data"
                           and sizes["data"] > 1 for ax in spec)
        for i, ((q, s), (qs, ss)) in enumerate(zip(res["moments_full"],
                                                   qspecs)):
            lq, ls = res["moments_local"][r][i]
            np.testing.assert_array_equal(lq, _jax_block(q, qs, sizes,
                                                         coords))
            np.testing.assert_array_equal(ls, _jax_block(s, ss, sizes,
                                                         coords))
    # (2, 2, 1) really lays out ("data", "pod"); both meshes shard the
    # moments over ("data", "model", "pod")
    assert strided == (shape == (2, 2, 1))
    assert any(qs[0] == ("data", "model", "pod") for qs, _ in qspecs)


@pytest.mark.parametrize("shape", W.POD_MESHES)
def test_pod_hp_trains_like_one_rank(pod_ranks, single_rank, shape):
    res = pod_ranks[shape]
    np.testing.assert_allclose(res["losses"], single_rank["losses"],
                               rtol=TOL["HP"], atol=TOL["HP"])
    np.testing.assert_allclose(res["int8_losses"], single_rank["int8"],
                               rtol=2e-3, atol=2e-3)
    _assert_single_rank_grads(W.POD_ARCH, res["grads"])


@pytest.mark.parametrize("shape", W.POD_MESHES)
def test_pod_checkpoint_and_resize_onto_4x1(pod_ranks, shape):
    res = pod_ranks[shape]
    assert res["restored_equal"]
    assert res["resized_equal"]
    assert res["resized_placements"][0] != ""


@pytest.mark.parametrize("shape", W.POD_MESHES)
def test_compressed_allreduce_over_pod_is_the_references_mean(pod_ranks,
                                                             shape):
    res = pod_ranks[shape]
    ranks = res["ef"]
    errs = [{k: jnp.zeros(s, jnp.float32) for k, s in W.EF_SHAPES.items()}
            for _ in ranks]
    for t in range(W.EF_ROUNDS):
        deqs = []
        for r, got in enumerate(ranks):
            q, corrected = JEF.compress(
                {k: jnp.asarray(v) for k, v in got["grads"][t].items()},
                errs[r])
            deq, errs[r] = JEF.decompress_and_update_error(q, corrected)
            deqs.append(deq)
            for k in W.EF_SHAPES:
                np.testing.assert_array_equal(got["out"][t][1][k],
                                              np.asarray(errs[r][k]))
        for r, c in enumerate(res["coords"]):
            group = [j for j, cj in enumerate(res["coords"])
                     if cj[1:] == c[1:]]
            assert len(group) == 2
            for k in W.EF_SHAPES:
                want = np.mean([np.asarray(deqs[j][k]) for j in group],
                               axis=0, dtype=np.float32)
                np.testing.assert_array_equal(ranks[r]["out"][t][0][k],
                                              want)


def test_error_feedback_compression_converges():
    """tests/test_optim.py's case on the port: the accumulated compressed
    sum tracks the exact sum, and every step's int8 codes, scales and
    error residuals equal the reference's."""
    key = jax.random.PRNGKey(0)
    grads_seq = [{"w": jax.random.normal(jax.random.fold_in(key, i),
                                         (256,))} for i in range(30)]
    jerr = JEF.init_error_state(grads_seq[0])
    err = EF.init_error_state({"w": torch.zeros(256)})
    exact = np.zeros((256,), np.float32)
    approx = np.zeros((256,), np.float32)
    for g in grads_seq:
        jq, jcorr = JEF.compress(g, jerr)
        jdeq, jerr = JEF.decompress_and_update_error(jq, jcorr)
        q, corrected = EF.compress({"w": torch.from_numpy(
            np.array(g["w"]))}, err)
        deq, err = EF.decompress_and_update_error(q, corrected)
        np.testing.assert_array_equal(q["w"].q.numpy(),
                                      np.asarray(jq["w"].q))
        np.testing.assert_array_equal(q["w"].scale.numpy(),
                                      np.asarray(jq["w"].scale))
        np.testing.assert_array_equal(err["w"].numpy(),
                                      np.asarray(jerr["w"]))
        exact = exact + np.asarray(g["w"])
        approx = approx + deq["w"].numpy()
    # error feedback keeps the drift bounded by one quantization step
    drift = float(np.max(np.abs(exact - approx)))
    scale = float(np.max(np.abs(exact)))
    assert drift < 0.1 * scale + 0.1


def test_compress_codes_are_the_references_off_block():
    """Leaves that do not fill whole 256-blocks (zero padding) and leaves
    of other dtypes: codes, scales and residuals equal the reference's."""
    rng = np.random.default_rng(7)
    grads = {"a": rng.standard_normal((3, 100)).astype(np.float32),
             "b": (rng.standard_normal(513) * 1e-3).astype(np.float32)}
    jq, jcorr = JEF.compress({k: jnp.asarray(v) for k, v in grads.items()},
                             JEF.init_error_state(grads))
    jdeq, jerr = JEF.decompress_and_update_error(jq, jcorr)
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    q, corrected = EF.compress(tg, EF.init_error_state(tg))
    deq, err = EF.decompress_and_update_error(q, corrected)
    for k in grads:
        assert isinstance(jq[k], JQLeaf)
        np.testing.assert_array_equal(q[k].q.numpy(), np.asarray(jq[k].q))
        np.testing.assert_array_equal(q[k].scale.numpy(),
                                      np.asarray(jq[k].scale))
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
        np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))

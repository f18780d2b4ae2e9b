"""The port's kernel modules (``repro_torch.kernels``) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_kernels.py
runs them, and against the JAX plain versions (``repro.kernels.ref``).

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card by
tests/test_torch_gpu.py and by ``chip_smoke.py``.  Inputs
are made with numpy from a fixed seed and handed to both frameworks.
Tolerances are those of tests/test_kernels.py: 2e-5 in fp32, 2e-2 in bf16.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trn

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(t: torch.Tensor, j, tol: float):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# the case lists of tests/test_kernels.py, scaled down
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (2, 128, 4, 2, 64),
    (1, 150, 2, 2, 32),      # non-multiple-of-block seq (ragged)
    (2, 64, 8, 1, 32),       # MQA
    (1, 256, 4, 4, 16),      # two kv tiles
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_pallas_and_ref(B, S, H, Hkv, D, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    tol = DTYPES[dtype][2]
    before = tfa.flash_attention.launches
    got = tops.flash_attention(tq, tk, tv)
    assert got.shape == (B, S, H, D) and got.dtype == tq.dtype
    assert tfa.flash_attention.launches == before   # CPU: the plain version
    _close(got, jops.flash_attention(jq, jk, jv), tol)
    jkx = jnp.repeat(jk, H // Hkv, axis=2)
    jvx = jnp.repeat(jv, H // Hkv, axis=2)
    _close(got, jref.flash_attention_ref(jq, jkx, jvx,
                                         scale=1.0 / np.sqrt(D)), tol)


@pytest.mark.parametrize("S,T,causal", [(100, 260, True), (260, 100, True),
                                        (100, 260, False)])
def test_flash_attention_s_ne_t_top_left_mask(S, T, causal):
    """S != T on the Pallas kernel itself: its causal mask is top-left
    (query i sees keys 0..i); the port's (B,H,S,D) wrapper keeps it."""
    rng = np.random.default_rng(1)
    B, H, D = 1, 2, 32
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, H, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("shape", [(4, 37, 128), (2, 256), (1, 7, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_pallas_and_ref(shape, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    (jx, tx), (js, ts) = _pair(x, dtype), _pair(s, "float32")
    tol = DTYPES[dtype][2]
    before = trn.rmsnorm.launches
    got = tops.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert trn.rmsnorm.launches == before
    _close(got, jops.rmsnorm(jx, js), tol)
    _close(got, jref.rmsnorm_ref(jx, js), tol)


def test_plain_versions_are_what_the_wrappers_run_on_cpu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    s = torch.ones(64)
    assert torch.equal(trn.rmsnorm(x, s), tref.rmsnorm_ref(x, s))
    q = torch.from_numpy(rng.standard_normal((1, 4, 9, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
    got = tfa.flash_attention(q, k, k)
    want = tref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    k.transpose(1, 2), scale=0.25)
    assert torch.equal(got, want.transpose(1, 2))


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trn.rmsnorm(x, torch.empty((8,), device="meta"))
    q = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, q, q)


def test_build_is_keyed_by_source_hash_and_needs_nvcc():
    paths = {n: build.lib_path(n) for n in build.SOURCES}
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so"
               for p in paths.values())
    assert paths == {n: build.lib_path(n) for n in build.SOURCES}
    assert len({p.name for p in paths.values()}) == len(paths)
    if shutil.which("nvcc") is None and not any(p.exists()
                                                for p in paths.values()):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build()

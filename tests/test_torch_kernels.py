"""The port's kernel modules (``repro_torch.kernels``) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_kernels.py
runs them, and against the JAX plain versions (``repro.kernels.ref``,
``repro.models.mamba2._ssd_chunked``).

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card by
tests/test_torch_gpu.py and by ``chip_smoke.py``.  Inputs
are made with numpy from a fixed seed and handed to both frameworks.
Tolerances are those of tests/test_kernels.py: 2e-5 in fp32, 2e-2 in bf16;
the SSD scan is held at 1e-5 of its output's scale to its chunked twins
(``_close_scaled`` says why not elementwise) and at the 2e-3 of
tests/test_kernels.py to the sequential recurrence.
"""
import itertools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as JM2
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tssd

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
    (1, 150, 4, 4, 160),     # zamba2-2.7b's shared block: MHA, D = 160
    (1, 130, 4, 2, 256),     # gemma-7b's head dim, GQA
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


@pytest.mark.parametrize("shape", [(4, 37, 128), (2, 256), (1, 7, 512),
                                   (2, 12288)])
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


def _ssd_inputs(seed, B, S, H, P, N, G):
    """x, Bm, Cm ~ N(0, 1); dt = softplus(N(0, 1)); a = -exp(N(0, 1))·dt —
    the distributions of tests/test_kernels.py, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal((B, S, H))) * dt).astype(np.float32)
    return x, Bm, Cm, dt, a


def _close_scaled(t: torch.Tensor, j, tol: float):
    """max |t - j| <= tol * max |j|.  An SSD output is a sum of up to
    S·(Q + N) products many times its own size, so fp32 sums taken in
    another order differ by ~1e-6 of the output's scale, also at outputs
    near 0: an elementwise rtol would fail there on summation order
    alone."""
    want = np.asarray(j, np.float32)
    err = float(np.abs(t.float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def _ssd_torch(arrays, h0=None, chunk=128):
    ts = [torch.from_numpy(t) for t in arrays]
    h0 = None if h0 is None else torch.from_numpy(np.asarray(h0))
    return tops.ssd_scan(*ts, h0=h0, chunk=chunk)


# the cases of tests/test_kernels.py, plus a mamba2-780m-shaped narrow one
# (head_dim 64, d_state 128, chunk 128, ragged S = 300 over three chunks)
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (2, 64, 4, 16, 8, 1, 32),
    (1, 100, 2, 8, 16, 2, 32),    # ragged seq, multi-group
    (2, 33, 4, 32, 64, 1, 16),
    (1, 300, 4, 64, 128, 1, 128),
])
def test_ssd_scan_matches_pallas_chunked_and_sequential(B, S, H, P, N, G,
                                                        chunk):
    """fp32: the plain chunked scan (what the wrapper runs on the CPU) vs
    the Pallas kernel in interpret mode and vs ``_ssd_chunked`` at 1e-5;
    vs the sequential recurrence at the 2e-3 of tests/test_kernels.py."""
    cfg = JM2.Mamba2Config(d_model=H * P // 2, d_state=N, head_dim=P,
                           n_groups=G, chunk=chunk)
    arrays = _ssd_inputs(0, B, S, H, P, N, G)
    before = tssd.ssd_scan.launches
    y, hf = _ssd_torch(arrays, chunk=chunk)
    assert tssd.ssd_scan.launches == before     # CPU: the plain version
    assert y.shape == (B, S, H, P) and hf.shape == (B, H, P, N)
    assert y.dtype == hf.dtype == torch.float32
    jx = [jnp.asarray(t) for t in arrays]
    py, ph = jops.ssd_scan(cfg, *jx)
    _close_scaled(y, py, 1e-5)
    _close_scaled(hf, ph, 1e-5)
    cy, ch = JM2._ssd_chunked(cfg, jx[0], jx[1], jx[2], (jx[3], jx[4]))
    _close_scaled(y, cy, 1e-5)
    _close_scaled(hf, ch, 1e-5)
    hg = np.arange(H) // (H // G)
    sy, sh = jref.ssd_scan_ref(jx[0], jx[1][:, :, hg], jx[2][:, :, hg],
                               jx[3], jx[4])
    _close(y, sy, 2e-3)
    _close(hf, sh, 2e-3)


def test_ssd_scan_carries_state():
    """Scan over [0:S] == scan [0:k] then [k:S] from the carried state, as
    tests/test_kernels.py holds the Pallas kernel; and the split run equals
    the Pallas kernel's own split run fed the same h0."""
    B, S, H, P, N, chunk, k = 1, 64, 4, 16, 8, 16, 32
    cfg = JM2.Mamba2Config(d_model=32, d_state=N, head_dim=P, chunk=chunk)
    arrays = _ssd_inputs(1, B, S, H, P, N, 1)
    y_full, h_full = _ssd_torch(arrays, chunk=chunk)
    y1, h1 = _ssd_torch([t[:, :k] for t in arrays], chunk=chunk)
    y2, h2 = _ssd_torch([t[:, k:] for t in arrays], h0=h1.numpy(),
                        chunk=chunk)
    _close_scaled(y2, y_full[:, k:].numpy(), 1e-5)
    _close_scaled(h2, h_full.numpy(), 1e-5)
    _close_scaled(y1, y_full[:, :k].numpy(), 1e-6)
    jy2, jh2 = jops.ssd_scan(cfg, *[jnp.asarray(t[:, k:]) for t in arrays],
                             h0=jnp.asarray(h1.numpy()))
    _close_scaled(y2, jy2, 1e-5)
    _close_scaled(h2, jh2, 1e-5)


def test_ssd_scan_selects_where_exp_overflows_above_the_diagonal():
    """a = -60 a step: exp(cum_i - cum_j) for j > i is exp(60·(j-i)), inf
    from two rows apart.  The mask must select, so y and h_final stay
    finite and equal the Pallas kernel's."""
    B, S, H, P, N, G, chunk = 1, 16, 2, 8, 8, 1, 16
    x, Bm, Cm, dt, _ = _ssd_inputs(2, B, S, H, P, N, G)
    a = np.full((B, S, H), -60.0, np.float32)
    assert 120.0 > np.log(np.finfo(np.float32).max)     # exp(120) is inf
    y, hf = _ssd_torch((x, Bm, Cm, dt, a), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    cfg = JM2.Mamba2Config(d_model=8, d_state=N, head_dim=P, chunk=chunk)
    py, ph = jops.ssd_scan(cfg, *(jnp.asarray(t) for t in (x, Bm, Cm, dt, a)))
    _close_scaled(y, py, 1e-5)
    _close_scaled(hf, ph, 1e-5)


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
    x, Bm, Cm, dt, a = (torch.from_numpy(t)
                        for t in _ssd_inputs(3, 1, 9, 4, 8, 6, 2))
    y, hf = tssd.ssd_scan(x, Bm, Cm, dt, a, chunk=4)
    wy, wh = tref.ssd_scan_ref(x, Bm, Cm, dt, a, chunk=4)
    assert torch.equal(y, wy) and torch.equal(hf, wh)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trn.rmsnorm(x, torch.empty((8,), device="meta"))
    q = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, q, q)
    d = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tssd.ssd_scan(q, q, q, d, d)


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


# ---------------------------------------------------------------------------
# the bf16 flash kernel's arithmetic, emulated: why P is split into hi + lo
# ---------------------------------------------------------------------------

def _smoke():
    """chip_smoke.py as a module, for its own kernel checks (it imports no
    JAX)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _smoke_check_close():
    return _smoke().check_close


def _flash_tiled_bf16(q, k, v, *, scale, causal, bk, split):
    """The bf16 kernel's arithmetic in plain torch: QK^T of bf16 inputs in
    fp32, an online softmax over kv tiles of ``bk`` keys, and PV summed in
    fp32 from P rounded to bf16, either once (``split=False``) or as
    hi = bf16(P) plus lo = bf16(P - hi).  q: (B,S,H,D), k,v: (B,T,Hkv,D)
    bf16 -> (B,S,H,D) fp32, before the final cast."""
    B, S, H, D = q.shape
    T, g = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)                               # (B,H,S,D)
    kf, vf = (t.float().repeat_interleave(g, dim=2).transpose(1, 2)
              for t in (k, v))
    m = torch.full((B, H, S), tref.NEG_INF)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    qp = torch.arange(S)[:, None]
    for k0 in range(0, T, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = qf @ kt.transpose(-1, -2) * scale
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        keep = (qp >= kp) if causal else torch.ones_like(qp >= kp)
        s = torch.where(keep, s, torch.tensor(tref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2)


@pytest.mark.parametrize("D", [128, 160, 256])
@pytest.mark.parametrize("S,T,causal", [(512, 512, True), (300, 700, False)])
def test_flash_bf16_needs_p_split_into_hi_and_lo(S, T, causal, D):
    """At the forward's shape (fewer heads) and a ragged one, at qwen3-8b's,
    zamba2-2.7b's and gemma-7b's head dims: with P as bf16 hi + lo the
    tiled kernel arithmetic stays within ~1e-5 of the fp32 plain version
    and passes chip_smoke's bf16 check after the cast; with P rounded to
    bf16 once, its error is over 100x larger and the check fails.  BK =
    64, the kernel's kv tile at every D."""
    check_close = _smoke_check_close()
    rng = np.random.default_rng(0)
    B, H, Hkv = 1, 4, 1
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, h, D))
                                .astype(np.float32)).to(torch.bfloat16)
               for n, h in ((S, H), (T, Hkv), (T, Hkv)))
    scale = D ** -0.5
    exact = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     scale=scale, causal=causal)
    want = tref.flash_attention_ref(q, k, v, scale=scale, causal=causal)
    got = {split: _flash_tiled_bf16(q, k, v, scale=scale, causal=causal,
                                    bk=64, split=split)
           for split in (True, False)}
    err = {split: float((g - exact).abs().max()) for split, g in got.items()}
    assert err[True] * 100 <= err[False], err
    assert err[True] < 2e-5, err
    _, ok_split, _ = check_close(got[True].to(torch.bfloat16), want,
                                 "bfloat16")
    _, ok_single, _ = check_close(got[False].to(torch.bfloat16), want,
                                  "bfloat16")
    assert ok_split and not ok_single


# ---------------------------------------------------------------------------
# the bf16 SSD kernel's arithmetic, emulated: its three phases, and why each
# fp32 factor is split into hi + lo
# ---------------------------------------------------------------------------

def _round(v: torch.Tensor, how: str) -> torch.Tensor:
    """An fp32 factor as a bf16 tensor-core product sees it: unchanged
    ("fp32"), as bf16 hi + lo ("hilo") or rounded to bf16 once
    ("single")."""
    if how == "fp32":
        return v
    hi = v.to(torch.bfloat16).float()
    return hi if how == "single" else hi + (v - hi).to(torch.bfloat16).float()


def _ssd_three_phase(x, Bm, Cm, dt, a, h0=None, *, chunk,
                     w="fp32", scores="fp32", h="fp32"):
    """The bf16 kernel's algebra in plain torch, with every chunk at once
    where the kernel has a block each: (a) each chunk's own state s_c =
    sum_j w_j (x) B_j from 0, w_j = exp(cum_last - cum_j) dt_j x_j; (b) the
    pass h_c = exp(cum_last^c) h_{c-1} + s_c from h0; (c) y = S x +
    exp(cum_i) C h_{c-1}^T with S = select(j <= i, C.B^T exp(cum_i - cum_j)
    dt_j, 0).  ``w``, ``scores`` and ``h`` say how each fp32 factor is
    rounded (``_round``); B, C and x are the inputs' own values.  Shapes
    as ``ref.ssd_scan_ref``; returns (y, h_final) fp32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    x, Bm, Cm, dt, a = (t.float() for t in (x, Bm, Cm, dt, a))
    pad = (-S) % Q
    if pad:
        x, Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                     for t in (x, Bm, Cm))
        dt, a = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, a))
    nc = x.shape[1] // Q
    hg = torch.arange(H) // (H // G)
    xc = x.reshape(Bsz, nc, Q, H, P)
    Bc, Cc = (t.reshape(Bsz, nc, Q, G, N)[:, :, :, hg]
              for t in (Bm, Cm))                           # (B,nc,Q,H,N)
    dtc, ac = (t.reshape(Bsz, nc, Q, H) for t in (dt, a))
    cum = torch.cumsum(ac, dim=2)                          # row order
    last = cum[:, :, -1]                                   # (B,nc,H)
    # (a) chunk states, all chunks in parallel
    wv = (torch.exp(last[:, :, None] - cum) * dtc)[..., None] * xc
    st = torch.einsum("bcqhp,bcqhn->bchpn", _round(wv, w), Bc)
    # (b) the serial pass; hin[c] is the state chunk c starts from
    hc = (torch.zeros((Bsz, H, P, N)) if h0 is None else h0.float())
    hin = []
    for c in range(nc):
        hin.append(hc)
        hc = torch.exp(last[:, c])[:, :, None, None] * hc + st[:, c]
    hin = torch.stack(hin, dim=1)                          # (B,nc,H,P,N)
    # (c) chunk outputs, all chunks in parallel
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros(()))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    sc = cb * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", _round(sc, scores), xc)
    y = y + torch.einsum("bcqhn,bchpn->bcqhp", Cc, _round(hin, h)) * \
        torch.exp(cum)[..., None]
    return y.reshape(Bsz, nc * Q, H, P)[:, :S], hc


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk", [
    (2, 64, 4, 16, 8, 1, 32),
    (1, 100, 2, 8, 16, 2, 32),    # ragged seq, multi-group
    (2, 33, 4, 32, 64, 1, 16),
    (1, 300, 4, 64, 128, 1, 128),
])
def test_ssd_three_phase_algebra_matches_ref_and_chunked(B, S, H, P, N, G,
                                                         chunk, with_h0):
    """fp32: chunk states in parallel, then the pass, then the chunk
    outputs equal the plain scan and the JAX ``_ssd_chunked`` at 1e-5 of
    each output's scale, from h0 = 0 and from h0 != 0."""
    arrays = _ssd_inputs(4, B, S, H, P, N, G)
    h0 = (np.random.default_rng(5).standard_normal((B, H, P, N))
          .astype(np.float32) if with_h0 else None)
    ts = [torch.from_numpy(t) for t in arrays]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, hf = _ssd_three_phase(*ts, th0, chunk=chunk)
    wy, wh = tref.ssd_scan_ref(*ts, th0, chunk=chunk)
    _close_scaled(y, wy.numpy(), 1e-5)
    _close_scaled(hf, wh.numpy(), 1e-5)
    cfg = JM2.Mamba2Config(d_model=H * P // 2, d_state=N, head_dim=P,
                           n_groups=G, chunk=chunk)
    jx = [jnp.asarray(t) for t in arrays]
    cy, ch = JM2._ssd_chunked(cfg, jx[0], jx[1], jx[2], (jx[3], jx[4]),
                              h0=None if h0 is None else jnp.asarray(h0))
    _close_scaled(y, cy, 1e-5)
    _close_scaled(hf, ch, 1e-5)


@pytest.mark.parametrize("rounded_once", [None, "w", "scores", "h"])
def test_ssd_bf16_needs_each_fp32_factor_split_into_hi_and_lo(rounded_once):
    """At mamba2-780m's widths (48 heads of 64, d_state 128, chunk 128)
    with two groups, three chunks (S = 300) and h0 != 0, bf16 inputs and
    the decays of the card's mutant test (dt = softplus(N(0, 1)), A =
    -(1..H)): the kernel's arithmetic with w, the scores and h each split
    into bf16 hi + lo passes chip_smoke.py's SSD check against the plain
    scan; rounding any one of them to bf16 once fails it."""
    check_ssd = _smoke().check_ssd
    rng = np.random.default_rng(0)
    B, S, H, P, N, G = 1, 300, 48, 64, 128, 2

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    x, Bm, Cm = bf16(B, S, H, P), bf16(B, S, G, N), bf16(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    a = dt * -torch.arange(1, H + 1, dtype=torch.float32)
    h0 = torch.from_numpy(rng.standard_normal((B, H, P, N))
                          .astype(np.float32))
    how = {k: "single" if k == rounded_once else "hilo"
           for k in ("w", "scores", "h")}
    got = _ssd_three_phase(x, Bm, Cm, dt, a, h0, chunk=128, **how)
    want = tref.ssd_scan_ref(x, Bm, Cm, dt, a, h0)
    err, ok, tol = check_ssd(got, want)
    assert ok == (rounded_once is None), (rounded_once, err, tol)


# ---------------------------------------------------------------------------
# RMSNorm's launch shape (chosen in Python, checked again by the C side)
# ---------------------------------------------------------------------------

def _rmsnorm_source_constants():
    import re
    src = (build.CSRC / "rmsnorm.cu").read_text()
    min_block = int(re.search(r"constexpr int kMinBlock = (\d+);", src)[1])
    max_nv = int(re.search(r"constexpr int kMaxNV = (\d+);", src)[1])
    span = int(re.search(r"constexpr int kMaxVecSpan = (\d+);", src)[1])
    loop = int(re.search(r"constexpr int kLoopLanes = (\d+);", src)[1])
    lanes = tuple(int(n) for n in re.findall(
        r"case (\d+): +return launch<T, TS, VEC, \1>", src))
    return min_block, max_nv, span, lanes, loop


def _rmsnorm_covered(shape, D, itemsize, max_nv, span):
    """Assert that a launch shape covers a row of D elements once: every
    vector a slot (vector vi at lane vi % lanes, slot vi // lanes) and no
    lane's last slot wholly past the row; register-held up to
    ``trn.max_register_d`` (at most ``max_nv`` vectors a lane, vector
    groups no wider than ``span``), the looped body past it (LOOP_LANES
    threads, one row a block)."""
    lanes, nv, rows, vec = shape
    full = 16 // itemsize
    assert vec == (full if D % full == 0 else 1), (D, itemsize)
    nvec = D // vec
    assert nvec * vec == D
    assert lanes * nv >= nvec > lanes * (nv - 1), (D, itemsize)
    if D > trn.max_register_d(vec, backward=max_nv < trn.MAX_VECS_PER_LANE):
        assert (lanes, rows) == (trn.LOOP_LANES, 1), (D, itemsize)
        return
    assert lanes in trn.LANE_GROUPS and 1 <= nv <= max_nv
    # the narrowest group that holds the row (the rule at every width the
    # kernel took before rows past 8,192 were taken, so theirs hold)
    assert lanes == trn.LANE_GROUPS[0] or (lanes // 2) * max_nv < nvec
    assert vec == 1 or lanes * vec <= span
    assert lanes * rows == max(trn.MIN_BLOCK, lanes) <= 1024
    slots = (np.arange(lanes)[:, None]
             + lanes * np.arange(nv)[None, :]).ravel()
    used = np.sort(slots[slots < nvec])
    assert np.array_equal(used, np.arange(nvec)), (D, itemsize)


# every width up to 8,192, then every 8th (the vectors' step) and its odd
# neighbour up to twice that, past the register-held maximum of 16,384
RMSNORM_WIDTHS = [*range(1, 8193), *(d + e for d in range(8200, 16401, 8)
                                     for e in (0, 1)), 24576, 49152]


def test_rmsnorm_launch_shape_covers_every_width_once():
    """For every width of ``RMSNORM_WIDTHS`` and both item sizes: the lane
    group, vectors a lane and vector width cover the row's D elements
    exactly once, with no lane's last vector wholly past the row; the
    register-held body's block has at most 1024 threads, exactly the count
    the C build's ``__launch_bounds__(max(kMinBlock, LANES))`` was made
    for, and takes rows up to 16,384 in vectors (8,192 in elements); wider
    rows take the looped body; and the constants match csrc/rmsnorm.cu,
    whose vector builds span at most ``kMaxVecSpan`` elements a row
    group."""
    min_block, max_nv, span, built_lanes, loop = _rmsnorm_source_constants()
    assert (min_block, max_nv) == (trn.MIN_BLOCK, trn.MAX_VECS_PER_LANE)
    assert (span, loop) == (trn.MAX_VEC_SPAN, trn.LOOP_LANES)
    assert built_lanes == trn.LANE_GROUPS
    assert trn.max_register_d(8) == trn.max_register_d(4) == 16384
    assert trn.max_register_d(1) == 8192
    for itemsize in (2, 4):
        for D in RMSNORM_WIDTHS:
            _rmsnorm_covered(trn.launch_shape(D, itemsize), D, itemsize,
                             max_nv, span)


# the launch shapes of the paths' widths, (forward, backward) in bf16 and
# fp32, as the kernel had them before rows past 8,192 were taken: the
# widths' rows keep their times
RMSNORM_PATH_SHAPES = {
    128: [(8, 2, 32, 8), (8, 4, 32, 4), (8, 2, 32, 8), (8, 4, 32, 4)],
    1536: [(32, 6, 8, 8), (64, 6, 4, 4), (64, 3, 4, 8), (128, 3, 2, 4)],
    2560: [(64, 5, 4, 8), (128, 5, 2, 4), (128, 3, 2, 8), (256, 3, 1, 4)],
    3072: [(64, 6, 4, 8), (128, 6, 2, 4), (128, 3, 2, 8), (256, 3, 1, 4)],
    4096: [(64, 8, 4, 8), (128, 8, 2, 4), (128, 4, 2, 8), (256, 4, 1, 4)],
    5120: [(128, 5, 2, 8), (256, 5, 1, 4), (256, 3, 1, 8), (512, 3, 1, 4)],
    12288: [(256, 6, 1, 8), (512, 6, 1, 4), (512, 3, 1, 8), (1024, 3, 1, 4)],
}


@pytest.mark.parametrize("D", sorted(RMSNORM_PATH_SHAPES))
def test_rmsnorm_launch_shape_idles_no_lane_at_the_model_widths(D):
    """The models' widths (q/k norms 128; d_model and d_inner of
    mamba2-780m, zamba2-2.7b, gemma-7b and qwen3-8b; command-r-plus-104b's
    12,288) in bf16: every lane slot holds a vector of the row, and the
    shapes are the ones these widths have run at (both dtypes, forward
    and backward)."""
    lanes, nv, _, vec = trn.launch_shape(D, 2)
    assert vec == 8 and lanes * nv * vec == D
    assert [trn.launch_shape(D, 2), trn.launch_shape(D, 4),
            trn.bwd_launch_shape(D, 2), trn.bwd_launch_shape(D, 4)] == \
        RMSNORM_PATH_SHAPES[D]


def test_rmsnorm_launch_shape_falls_back_to_elements():
    """Widths that are not a multiple of the vector, and pointers that are
    not 16-byte aligned, take single elements (the C side refuses vectors
    there)."""
    assert trn.launch_shape(300, 2)[3] == 1
    assert trn.launch_shape(4098, 4)[3] == 1
    assert trn.launch_shape(4096, 2, aligned=False)[3] == 1
    assert trn.launch_shape(4096, 4)[3] == 4
    with pytest.raises(ValueError, match="at least 1"):
        trn.launch_shape(0, 2)
    # rows wider than 8,192 are taken (the reference's kernel takes any D):
    # command-r-plus-104b's 12,288 on the register-held body, an odd width
    # past 8,192 on the looped one in single elements
    assert trn.launch_shape(12288, 2) == (256, 6, 1, 8)
    assert trn.launch_shape(12288, 4) == (512, 6, 1, 4)
    assert trn.bwd_launch_shape(12288, 2) == (512, 3, 1, 8)
    assert trn.launch_shape(8193, 2) == (trn.LOOP_LANES, 9, 1, 1)
    assert trn.bwd_launch_shape(8193, 4) == (trn.LOOP_LANES, 9, 1, 1)


# ---------------------------------------------------------------------------
# gradients of the plain versions, against jax.grad of the jnp twins
# ---------------------------------------------------------------------------

def _close_normwise(t: torch.Tensor, j, tol: float):
    """max |t - j| <= tol * max |j| (bf16 gradients are sums of products
    of rounded values, elementwise near 0 they carry no relative
    accuracy)."""
    want = np.asarray(j, np.float32)
    err = float(np.abs(t.float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


@pytest.mark.parametrize("shape", [(4, 37, 128), (3, 300)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_ref_grads_match_jax_grad(shape, dtype):
    from repro.models import layers as JL
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    (jx, tx), (js, ts), (jg, tg) = (_pair(a, dtype) for a in (x, s, gy))
    tol = 1e-5 if dtype == "float32" else 2e-2
    _, vjp = jax.vjp(lambda a, b: JL.rmsnorm({"scale": b}, a), jx, js)
    jdx, jds = vjp(jg)
    tx.requires_grad_()
    ts.requires_grad_()
    tref.rmsnorm_ref(tx, ts).backward(tg)
    _close_normwise(tx.grad, jdx, tol)
    _close_normwise(ts.grad, jds, tol)


# (B, S, T, H, Hkv, D, causal): GQA, S != T both ways, the new head dims
FLASH_GRAD_CASES = [
    (2, 40, 40, 4, 2, 32, True),
    (1, 24, 50, 4, 1, 32, True),
    (1, 50, 24, 2, 2, 32, True),
    (1, 33, 33, 4, 2, 160, True),
    (1, 20, 45, 2, 1, 256, False),
]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", FLASH_GRAD_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_ref_grads_match_jax_grad(B, S, T, H, Hkv, D,
                                                  causal, dtype):
    """The plain attention the backward kernel is held to, against
    jax.grad of the reference's own plain attention (``layers._sdpa``).
    JAX's bf16 einsum rounds the logits to bf16 and the softmax back to
    bf16 before PV; the plain version keeps both in fp32, which the bf16
    tolerance covers."""
    from repro.models import layers as JL
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D),
                                 (B, S, H, D)))
    pairs = [_pair(a, dtype) for a in (q, k, v, do)]
    scale = 1.0 / np.sqrt(D)
    _, vjp = jax.vjp(lambda a, b, c: JL._sdpa(a, b, c, causal=causal,
                                              scale=scale),
                     *(p[0] for p in pairs[:3]))
    jgrads = vjp(pairs[3][0])
    tq, tk, tv = (p[1].requires_grad_() for p in pairs[:3])
    tref.flash_attention_ref(tq, tk, tv, scale=scale,
                             causal=causal).backward(pairs[3][1])
    tol = 1e-5 if dtype == "float32" else 2e-2
    for t, j in zip((tq, tk, tv), jgrads):
        _close_normwise(t.grad, j, tol)


# ---------------------------------------------------------------------------
# the flash backward's design, emulated: csrc/flash_attention_bwd.cu
# ---------------------------------------------------------------------------

def _flash_lse_tiled(q, k, *, scale, causal, bk):
    """The forward kernel's logsumexp in plain torch: an online max and
    sum over kv tiles of ``bk`` keys, lse = m + log(max(l, 1e-30)).
    q: (B,H,S,D), k: (B,H,T,D) fp32 -> (B,H,S)."""
    S, T = q.shape[2], k.shape[2]
    m = torch.full(q.shape[:3], tref.NEG_INF)
    l = torch.zeros(q.shape[:3])
    qp = torch.arange(S)[:, None]
    for k0 in range(0, T, bk):
        s = q @ k[:, :, k0:k0 + bk].transpose(-1, -2) * scale
        kp = torch.arange(k0, min(k0 + bk, T))[None, :]
        if causal:
            s = torch.where(qp >= kp, s, torch.tensor(tref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    return m + torch.log(l.clamp_min(1e-30))


def _flash_bwd_tiled(q, k, v, o, do, lse, *, scale, causal, r, split,
                     round_bf16=False, drop_mask=False, one_head=False,
                     drop_di=False, lse_natural=False, drop_peer=False):
    """csrc/flash_attention_bwd.cu in plain fp32 torch, by tiles of ``r``
    rows: Di = rowsum(dO * O) and lse2 = log2(e) * lse (the pre-pass); P =
    exp2(scale log2(e) q.k - lse2), masked to 0 outside the top-left
    causal window; dS = P (dP - Di).  dK/dV: each (kv head, key tile)'s
    items, the group's (q head, q tile) pairs at or below the diagonal in
    head-major order, are dealt to ``split`` units and summed in each unit
    in order: split = 4 is the tensor-core body at D <= 128 (item j to
    cluster rank j % 2, then warpgroup (j // 2) % 2; the units meet as
    (rank 0 wg 0 + rank 0 wg 1) + (rank 1 wg 0 + rank 1 wg 1)), split = 2
    the one at D = 160 (item j to cluster rank j % 2, whose warpgroups
    split it by product, one summing dV and one dK; the units meet as rank
    0 + rank 1), split = 1 the FMA body (one block walks every item; it
    takes exp of the natural-log lse, equal to this up to rounding).  dQ: each (q head, q tile) over the key
    tiles at or left of its diagonal, in order.  ``round_bf16`` rounds P^T
    and dS^T to bf16 where the tensor cores take them (sums stay fp32).
    q, o, do: (B,H,S,D); k, v: (B,Hkv,T,D).  The other flags are the
    one-edit wrong kernels of tests/test_torch_gpu.py."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = H // Hkv
    log2e = 1.4426950408889634
    di = (do * o).sum(-1)
    if drop_di:
        di = torch.zeros_like(di)
    lse2 = lse if lse_natural else lse * log2e
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))

    def bf(t):
        return t.to(torch.bfloat16).float() if round_bf16 else t

    def visible(q0, nq, k0, nk):
        qp = torch.arange(q0, q0 + nq)[:, None]
        kp = torch.arange(k0, k0 + nk)[None, :]
        keep = (qp < S) & (kp < T)
        if causal:
            keep &= qp >= kp
        return torch.ones_like(keep) if drop_mask else keep

    def scores(h, hk, q0, k0):
        qs, dos = q[:, h, q0:q0 + r], do[:, h, q0:q0 + r]
        ks, vs = k[:, hk, k0:k0 + r], v[:, hk, k0:k0 + r]
        s = qs @ ks.transpose(-1, -2)
        p = torch.where(visible(q0, qs.shape[1], k0, ks.shape[1]),
                        torch.exp2(s * (scale * log2e)
                                   - lse2[:, h, q0:q0 + r, None]),
                        torch.zeros(()))
        ds = p * (dos @ vs.transpose(-1, -2) - di[:, h, q0:q0 + r, None])
        return qs, dos, ks, p, ds

    for hk in range(Hkv):
        for k0 in range(0, T, r):
            heads = range(hk * group, hk * group + (1 if one_head else group))
            q_first = min(k0 // r, -(-S // r)) * r if causal else 0
            items = [(h, q0) for h in heads for q0 in range(q_first, S, r)]
            units = [[torch.zeros_like(dk[:, hk, k0:k0 + r]),
                      torch.zeros_like(dv[:, hk, k0:k0 + r])]
                     for _ in range(split)]
            for j, (h, q0) in enumerate(items):
                u = (2 * (j % 2) + (j // 2) % 2 if split == 4 else
                     j % 2 if split == 2 else 0)
                qs, dos, _, p, ds = scores(h, hk, q0, k0)
                units[u][1] += bf(p).transpose(-1, -2) @ dos
                units[u][0] += bf(ds).transpose(-1, -2) @ qs
            if split == 4:
                block0 = [a + b for a, b in zip(units[0], units[1])]
                block1 = [a + b for a, b in zip(units[2], units[3])]
                tot = (block0 if drop_peer else
                       [a + b for a, b in zip(block0, block1)])
            elif split == 2:
                tot = (units[0] if drop_peer else
                       [a + b for a, b in zip(units[0], units[1])])
            else:
                tot = units[0]
            dk[:, hk, k0:k0 + r] = tot[0] * scale
            dv[:, hk, k0:k0 + r] = tot[1]
    for h in range(H):
        for q0 in range(0, S, r):
            last = min(T, q0 + r) if causal else T
            for k0 in range(0, last, r):
                _, _, ks, _, ds = scores(h, h // group, q0, k0)
                dq[:, h, q0:q0 + r] += bf(ds) @ ks
    return dq * scale, dk, dv


def _bwd_split(D):
    """The units the bf16 backward deals a key tile's items to at head
    dim D (``_flash_bwd_tiled``): four warpgroups at D <= 128, two blocks
    at D = 160, one block (the FMA body) at D = 256."""
    if D not in tfa.BWD_TENSOR_CORE_DIMS:
        return 1
    return 4 if D <= 128 else 2


def _flash_case(seed, B, S, T, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D),
                           (B, S, H, D)))


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,r", [
    (1, 150, 150, 4, 2, 32, True, 64),     # ragged S = T: 64 + 64 + 22
    (2, 70, 150, 4, 1, 16, True, 64),      # S < T, MQA
    (1, 150, 70, 2, 2, 16, True, 64),      # S > T: keys past T masked
    (1, 90, 130, 4, 2, 32, False, 64),
    (1, 70, 70, 2, 1, 256, True, 32),      # D = 256 tiles
    (1, 150, 150, 4, 4, 160, True, 64),    # D = 160: MHA, as zamba2's
    (1, 70, 150, 2, 2, 160, False, 64),    # D = 160, S < T
])
def test_flash_bwd_tiling_matches_autograd_of_the_plain_version(
        B, S, T, H, Hkv, D, causal, r):
    """The kernels' tiling, split of the dK/dV items and order of
    summation, in fp32: the tensor-core body's at D <= 128 (split over four
    warpgroups) and at D = 160 (over the cluster's two blocks, each block's
    warpgroups split by product), the FMA body's at D = 256."""
    split = _bwd_split(D)
    q, k, v, do = _flash_case(6, B, S, T, H, Hkv, D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    o = tref.flash_attention_ref(tq, tk, tv, scale=scale, causal=causal)
    o.backward(do)
    qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o.detach(),
                                                      do))
    lse = _flash_lse_tiled(qh, kh.repeat_interleave(H // Hkv, 1),
                           scale=scale, causal=causal, bk=64)
    got = _flash_bwd_tiled(qh, kh, vh, oh, doh, lse, scale=scale,
                           causal=causal, r=r, split=split)
    for g, t in zip(got, (tq, tk, tv)):
        torch.testing.assert_close(g.transpose(1, 2), t.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("wrong", ["drop_mask", "one_head", "drop_di",
                                   "lse_natural", "drop_peer"])
def test_flash_bwd_emulation_fails_each_wrong_kernel(wrong):
    """Each one-edit wrong backward kernel of tests/test_torch_gpu.py,
    emulated in the tensor-core body's arithmetic (P and dS rounded to
    bf16 once), misses the plain gradients by far more than the card's
    bf16 check allows (2e-2 of max |grad|)."""
    B, S, T, H, Hkv, D = 1, 150, 150, 4, 2, 32
    q, k, v, do = _flash_case(7, B, S, T, H, Hkv, D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    o = tref.flash_attention_ref(tq, tk, tv, scale=scale)
    o.backward(do)
    qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o.detach(),
                                                      do))
    lse = _flash_lse_tiled(qh, kh.repeat_interleave(H // Hkv, 1),
                           scale=scale, causal=True, bk=64)
    got = _flash_bwd_tiled(qh, kh, vh, oh, doh, lse, scale=scale,
                           causal=True, r=64, split=4, round_bf16=True,
                           **{wrong: True})
    errs = [float((g.transpose(1, 2) - t.grad).abs().max())
            / float(t.grad.abs().max()) for g, t in zip(got, (tq, tk, tv))]
    assert max(errs) > 5 * _smoke().BWD_TOL["bfloat16"], errs


@pytest.mark.parametrize("H,Hkv,D,S,causal", [
    (32, 8, 128, 128, True), (32, 8, 128, 150, False),     # qwen3-8b
    (4, 4, 160, 150, True), (4, 4, 160, 150, False),       # zamba2-2.7b
])
def test_flash_bwd_single_bf16_rounding_of_p_and_ds_stays_inside_bwd_tol(
        H, Hkv, D, S, causal):
    """At qwen3-8b's head layout (32 q heads in groups of 4, D = 128) and
    zamba2-2.7b's (MHA at D = 160, a few of its 32 heads) and a short S,
    from bf16 inputs and the forward's bf16 o: the tensor-core
    body's arithmetic with P^T and dS^T rounded to bf16 once passes
    chip_smoke's bf16 backward check against autograd through the plain
    version (what the card holds the kernel to), with room to spare; so
    the backward needs no hi + lo split, unlike the forward's PV
    (test_flash_bf16_needs_p_split_into_hi_and_lo).  Unrounded, the same
    emulation matches jax.grad of the reference's plain attention in fp32
    (1e-5 of max |grad|)."""
    from repro.models import layers as JL
    smoke = _smoke()
    B = 1
    q, k, v, do = (t.to(torch.bfloat16)
                   for t in _flash_case(10, B, S, S, H, Hkv, D))
    scale = D ** -0.5
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tref.flash_attention_ref(*refs, scale=scale, causal=causal)
    o.backward(do)
    want = [t.grad for t in refs]                       # bf16, as the card
    qh, kh, vh, oh, doh = (t.float().transpose(1, 2)
                           for t in (q, k, v, o.detach(), do))
    lse = _flash_lse_tiled(qh, kh.repeat_interleave(H // Hkv, 1),
                           scale=scale, causal=causal, bk=64)
    got = [g.transpose(1, 2) for g in _flash_bwd_tiled(
        qh, kh, vh, oh, doh, lse, scale=scale, causal=causal, r=64, split=_bwd_split(D),
        round_bf16=True)]
    err, ok, tol = smoke.check_normwise(
        [g.to(torch.bfloat16) for g in got], want, "bfloat16")
    assert ok, (err, tol)
    rel = max(float((g.float() - w.float()).abs().max())
              / float(w.float().abs().max()) for g, w in zip(got, want))
    assert rel < smoke.BWD_TOL["bfloat16"] / 2, rel
    # unrounded, from the fp32 o of the same (bf16-valued) inputs, against
    # jax.grad in fp32
    o32 = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   scale=scale, causal=causal)
    exact = _flash_bwd_tiled(qh, kh, vh, o32.transpose(1, 2), doh, lse,
                             scale=scale, causal=causal, r=64,
                             split=_bwd_split(D))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: JL._sdpa(a, b, c, causal=causal,
                                              scale=scale), jq, jk, jv)
    for g, j in zip(exact, vjp(jdo)):
        _close_normwise(g.transpose(1, 2), j, 1e-5)


@pytest.mark.parametrize("S,T,causal", [(150, 150, True), (70, 150, True),
                                        (150, 70, True), (90, 130, False)])
def test_flash_lse_convention_is_logsumexp_of_the_masked_logits(S, T,
                                                                causal):
    """lse = m + log(max(l, 1e-30)) in natural log from the kernel's online
    max and sum, against jax.nn.logsumexp of the -1e30-masked logits."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 2, S, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, T, 32)).astype(np.float32)
    scale = 1.0 / np.sqrt(32)
    logits = jnp.einsum("bhsd,bhtd->bhst", q, k) * scale
    if causal:
        logits = jnp.where(jnp.arange(S)[:, None] >= jnp.arange(T)[None, :],
                           logits, -1e30)
    want = jax.nn.logsumexp(logits, axis=-1)
    got = _flash_lse_tiled(torch.from_numpy(q), torch.from_numpy(k),
                           scale=scale, causal=causal, bk=64)
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# the fp32 flash bodies' split-TF32 arithmetic, emulated: csrc/
# flash_attention.cu flash_fwd_tf32_kernel, csrc/flash_attention_bwd.cu
# flash_bwd_kv_tf32_kernel and flash_bwd_dq_tf32_kernel
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 as a TF32 operand of the tensor cores: its top 19 bits (10
    mantissa bits), rounded toward zero on the bits (``split_tf32`` in
    csrc/hopper.cuh)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _mm_tc(a: torch.Tensor, b: torch.Tensor, how: str) -> torch.Tensor:
    """a @ b as the fp32 bodies' tensor cores take it, sums in fp32:
    "split" is small.big + big.small + big.big of the TF32 parts big =
    tf32(x), small = tf32(x - big) (mma3_n); "single" one TF32 product;
    "fp32" the exact fp32 product."""
    if how == "fp32":
        return a @ b
    ab, bb = _tf32(a), _tf32(b)
    if how == "single":
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


# csrc/flash_attention.cu Tf32<D>::kBK and csrc/flash_attention_bwd.cu
# Tf32Bwd<D>: kBQ, kNP, kBK, kWholeKeys, kSplitWarps
def _tf32_fwd_bk(D):
    return 80 if D <= 64 else 32


def _tf32_bwd_tiles(D):
    return dict(bq=72 if D <= 64 else 32, np=3 if D <= 64 else 2, bk=32,
                whole=208 if D <= 64 else 64, warps=6 if D <= 64 else 4)


_LOG2E = 1.4426950408889634


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (..., R, D) with zero rows appended up to n (cp.async's zero
    fill)."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def _flash_fwd_tf32(q, k, v, *, scale, causal, how="split"):
    """flash_fwd_tf32_kernel in plain torch, as it tiles: a warp's 16 q
    rows (zero rows past S), whole kv tiles of kBK keys (zero rows past T,
    masked) but for tiles wholly above the warp's rows, an online softmax
    in log2 units, P used as an operand from the accumulators.  q:
    (B,H,S,D), k, v: (B,Hkv,T,D) fp32 -> (o (B,H,S,D), lse (B,H,S))."""
    B, H, S, D = q.shape
    T, group = k.shape[2], H // k.shape[1]
    kx, vx = (t.repeat_interleave(group, 1) for t in (k, v))
    bk = _tf32_fwd_bk(D)
    scale2 = np.float32(scale * _LOG2E)
    o = torch.zeros((B, H, S, D))
    lse = torch.zeros((B, H, S))
    for r0 in range(0, S, 16):
        qs = _pad_rows(q[:, :, r0:r0 + 16], 16)
        rows = torch.arange(r0, r0 + 16)[:, None]
        m = torch.full((B, H, 16), tref.NEG_INF)
        l = torch.zeros((B, H, 16))
        acc = torch.zeros((B, H, 16, D))
        last = min(S, r0 + 16) if causal else T
        for k0 in range(0, min(T, last), bk):
            ks, vs = (_pad_rows(t[:, :, k0:k0 + bk], bk) for t in (kx, vx))
            keys = torch.arange(k0, k0 + bk)[None, :]
            keep = keys < T
            if causal:
                keep = keep & (keys <= rows)
            x = torch.where(keep, _mm_tc(qs, ks.transpose(-1, -2), how)
                            * scale2, torch.tensor(tref.NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _mm_tc(p, vs, how)
            m = m_new
        n = min(16, S - r0)
        denom = l.clamp_min(1e-30)
        o[:, :, r0:r0 + n] = (acc / denom[..., None])[:, :, :n]
        lse[:, :, r0:r0 + n] = (m * np.float32(np.log(2.0))
                                + torch.log(denom))[:, :, :n]
    return o, lse


def _flash_bwd_tf32(q, k, v, o, do, lse, *, scale, causal, how="split",
                    wrong=None):
    """The split-TF32 backward in plain torch, as it tiles (csrc/
    flash_attention_bwd.cu).  flash_bwd_kv_tf32_kernel: key tiles of 16 W
    keys (all T in one tile up to kWholeKeys, else as few and as even as
    kSplitWarps warps allow), one warp each 16 keys; the block walks the q
    steps (kBQ rows) of each q head of the group in order, each in passes
    of kNP 8-row slices (a pass wholly above the warp's keys skipped); Di
    and lse2 from the step's rows; S^T = K_w Q^T, dP^T = V_w dO^T, P^T,
    dS^T; dV += P^T dO, dK += dS^T Q; with all keys in the tile, dQ = dS K
    in place.  Otherwise flash_bwd_dq_tf32_kernel: 16 q rows a warp, whole
    kBK-key tiles, S and dP again, dQ += dS K.  q, o, do: (B,H,S,D); k, v:
    (B,Hkv,T,D) -> (dq, dk, dv, whole).  ``wrong``: one of the wrong
    kernels of tests/test_torch_gpu.py (FLASH_BWD_MUTANTS_TF32)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = H // Hkv
    c = _tf32_bwd_tiles(D)
    bq = c["bq"]
    scale2 = np.float32(scale * _LOG2E)
    lse2 = lse * np.float32(_LOG2E)
    di = (do * o).sum(-1)
    if wrong == "Di left out":
        di = torch.zeros_like(di)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    slices = -(-T // 16)
    whole = T <= c["whole"]
    warps = slices if whole else -(-slices // -(-slices // c["warps"]))
    late = 1 if wrong == "mask one key late" else 0

    def head(hk, j):
        return j * Hkv + hk if wrong == "kv heads interleaved" else \
            hk * group + j

    for hk in range(Hkv):
        for k0 in range(0, T, 16 * warps):
            kt = 16 * warps
            kl = (_pad_rows(k[:, hk, k0:k0 + kt], kt),
                  _pad_rows(v[:, hk, k0:k0 + kt], kt))
            acc_k = torch.zeros((B, kt, D))
            acc_v = torch.zeros((B, kt, D))
            q_first = k0 // bq * bq if causal else 0
            for j in range(group):
                h = head(hk, j)
                for q0 in range(q_first, S, bq):
                    qs, dos = (_pad_rows(t[:, h, q0:q0 + bq], bq)
                               for t in (q, do))
                    rows = torch.arange(q0, q0 + bq)
                    l2t, dit = (_pad_rows(t[:, h, q0:q0 + bq, None],
                                          bq)[..., 0] for t in (lse2, di))
                    n = min(bq, S - q0)
                    ds_all = torch.zeros((B, bq, kt))
                    passes = [slice(p, p + 8 * c["np"])
                              for p in range(0, n, 8 * c["np"])]
                    for w, sl in itertools.product(range(warps), passes):
                        kw = k0 + 16 * w
                        if kw >= T or (wrong == "last slice dropped"
                                       and kw + 16 >= T):
                            continue
                        if causal and q0 + sl.stop - 1 < kw:
                            continue
                        kw_, vw_ = (t[:, 16 * w:16 * w + 16] for t in kl)
                        st = _mm_tc(kw_, qs[:, sl].transpose(-1, -2), how)
                        dpt = _mm_tc(vw_, dos[:, sl].transpose(-1, -2), how)
                        keys = torch.arange(kw, kw + 16)[:, None]
                        r = rows[sl][None, :]
                        keep = (r < S) & (keys < T)
                        if causal:
                            keep = keep & (keys <= r + late)
                        pt = torch.where(keep, torch.exp2(
                            st * scale2 - l2t[:, None, sl]),
                            torch.zeros(()))
                        dst = pt * (dpt - dit[:, None, sl])
                        acc_v[:, 16 * w:16 * w + 16] += _mm_tc(
                            pt, dos[:, sl], how)
                        acc_k[:, 16 * w:16 * w + 16] += _mm_tc(
                            dst, qs[:, sl], how)
                        ds_all[:, sl, 16 * w:16 * w + 16] = \
                            dst.transpose(-1, -2)
                    if whole:
                        n = min(bq, S - q0)
                        dq[:, h, q0:q0 + n] = (_mm_tc(ds_all, kl[0], how)
                                               * scale)[:, :n]
            n = min(kt, T - k0)
            dk[:, hk, k0:k0 + n] = (acc_k * scale)[:, :n]
            dv[:, hk, k0:k0 + n] = acc_v[:, :n]
    if not whole:
        bk = c["bk"]
        for h in range(H):
            hk = h // group
            for r0 in range(0, S, 16):
                qs, dos = (_pad_rows(t[:, h, r0:r0 + 16], 16)
                           for t in (q, do))
                rows = torch.arange(r0, r0 + 16)[:, None]
                n = min(16, S - r0)
                l2 = _pad_rows(lse2[:, h, r0:r0 + 16, None], 16)
                d2 = _pad_rows(di[:, h, r0:r0 + 16, None], 16)
                acc = torch.zeros((B, 16, D))
                last = min(S, r0 + 16) if causal else T
                for k0 in range(0, min(T, last), bk):
                    ks, vs = (_pad_rows(t[:, hk, k0:k0 + bk], bk)
                              for t in (k, v))
                    keys = torch.arange(k0, k0 + bk)[None, :]
                    keep = (rows < S) & (keys < T)
                    if causal:
                        keep = keep & (keys <= rows)
                    s = _mm_tc(qs, ks.transpose(-1, -2), how)
                    dp = _mm_tc(dos, vs.transpose(-1, -2), how)
                    p = torch.where(keep, torch.exp2(s * scale2 - l2),
                                    torch.zeros(()))
                    acc += _mm_tc(p * (dp - d2), ks, how)
                dq[:, h, r0:r0 + n] = (acc * scale)[:, :n]
    return dq, dk, dv, whole


# (B, S, T, H, Hkv, D, causal): ViT-B's layout (S = T = 65, D = 64, not
# causal: one block a head, five warps), ViT-B/16's at 224 (S = T = 197:
# one block a head, 13 warps) and a causal one at D = 128 with GQA (past
# 64 keys: key tiles and the dQ kernel), each at small B and H
TF32_LAYOUTS = [(1, 65, 65, 2, 2, 64, False), (1, 197, 197, 2, 2, 64, False),
                (1, 150, 150, 4, 2, 128, True)]


def _tf32_case(seed, B, S, T, H, Hkv, D, causal):
    """Inputs from the seed, autograd of the plain version, and the same
    tensors in the kernels' (B, H, S, D) layout."""
    q, k, v, do = _flash_case(seed, B, S, T, H, Hkv, D)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tref.flash_attention_ref(*refs, scale=D ** -0.5, causal=causal)
    o.backward(do)
    heads = tuple(t.transpose(1, 2) for t in (q, k, v, o.detach(), do))
    return o.detach(), [t.grad for t in refs], heads


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", TF32_LAYOUTS)
def test_flash_fp32_forward_split_tf32_passes_the_fp32_check(B, S, T, H, Hkv,
                                                             D, causal):
    """The fp32 forward's tensor-core arithmetic as the kernel tiles it
    (16-row slices, 8-key granules): with every operand split into TF32
    big + small and three products, the output passes chip_smoke's fp32
    check against the plain version and its lse is the logsumexp; one
    TF32 product per product fails the check."""
    check_close = _smoke_check_close()
    want, _, (qh, kh, vh, _, _) = _tf32_case(12, B, S, T, H, Hkv, D, causal)
    scale = D ** -0.5
    got = {how: _flash_fwd_tf32(qh, kh, vh, scale=scale, causal=causal,
                                how=how) for how in ("split", "single")}
    err, ok, tol = check_close(got["split"][0].transpose(1, 2), want,
                               "float32")
    assert ok, (err, tol)
    err1, ok1, _ = check_close(got["single"][0].transpose(1, 2), want,
                               "float32")
    assert not ok1 and err1 > 10 * err, (err1, err)
    lse = _flash_lse_tiled(qh, kh.repeat_interleave(H // Hkv, 1),
                           scale=scale, causal=causal, bk=64)
    torch.testing.assert_close(got["split"][1], lse, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", TF32_LAYOUTS)
def test_flash_fp32_backward_split_tf32_passes_bwd_tol(B, S, T, H, Hkv, D,
                                                       causal):
    """The fp32 backward's tensor-core arithmetic as the kernels tile it,
    from the emulated forward's o and lse: split TF32 passes chip_smoke's
    fp32 backward check (BWD_TOL) against autograd of the plain version
    with an order of magnitude to spare; one TF32 product per product
    fails it.  ViT-B's T = 65 and ViT-B/16's 197 run the one-block-a-head
    design, the D = 128 layout key tiles and the dQ kernel."""
    smoke = _smoke()
    _, want, (qh, kh, vh, _, doh) = _tf32_case(13, B, S, T, H, Hkv, D,
                                               causal)
    scale = D ** -0.5
    res = {}
    for how in ("split", "single"):
        o, lse = _flash_fwd_tf32(qh, kh, vh, scale=scale, causal=causal,
                                 how=how)
        *grads, whole = _flash_bwd_tf32(qh, kh, vh, o, doh, lse,
                                        scale=scale, causal=causal, how=how)
        assert whole == (T <= 208 if D <= 64 else T <= 64)
        res[how] = smoke.check_normwise([g.transpose(1, 2) for g in grads],
                                        want, "float32")
    err, ok, tol = res["split"]
    assert ok and err <= smoke.BWD_TOL["float32"] / 10 * max(
        float(w.abs().max()) for w in want), (err, tol)
    assert not res["single"][1], res["single"]


@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", [
    (1, 65, 65, 2, 2, 64, False),      # ViT-B: one block a head, 80 x 72
    (2, 80, 80, 4, 1, 32, True),       # exactly five 16-key slices, MQA
    (1, 17, 100, 8, 2, 16, True),      # GQA 4, S < T
    (1, 100, 40, 2, 2, 64, True),      # S > T: keys past T masked
    (1, 1, 7, 2, 1, 128, False),       # one row, a key granule short
    (1, 197, 197, 2, 2, 64, False),    # ViT-B/16: one block of 13 warps
    (1, 120, 300, 2, 1, 32, False),    # past 208 keys: 4 tiles of 80 + dQ
    (1, 90, 300, 4, 2, 128, True),     # D = 128 key tiles, S < T
])
def test_flash_fp32_tf32_tiling_matches_autograd_and_jax_grad(B, S, T, H,
                                                              Hkv, D, causal):
    """The split-TF32 kernels' tiling in exact fp32 products: the forward's
    16-row slices and 8-key granules, the backward's five products of the
    one-block-a-head design (16-key slices a warp, q tiles cut at 8 rows,
    dQ in place) or its key tiles and dQ kernel past kWholeKeys, match the
    plain version and autograd of it (1e-5), and jax.grad of the
    reference's plain attention in fp32 (1e-5 of max |grad|)."""
    from repro.models import layers as JL
    want_o, want, (qh, kh, vh, oh, doh) = _tf32_case(14, B, S, T, H, Hkv, D,
                                                     causal)
    scale = D ** -0.5
    o, lse = _flash_fwd_tf32(qh, kh, vh, scale=scale, causal=causal,
                             how="fp32")
    torch.testing.assert_close(o.transpose(1, 2), want_o, rtol=1e-5,
                               atol=1e-5)
    *got, _ = _flash_bwd_tf32(qh, kh, vh, oh, doh, lse, scale=scale,
                              causal=causal, how="fp32")
    for g, w in zip(got, want):
        torch.testing.assert_close(g.transpose(1, 2), w, rtol=1e-5,
                                   atol=1e-5)
    jq, jk, jv, jdo = (jnp.asarray(t.transpose(1, 2).numpy())
                       for t in (qh, kh, vh, doh))
    _, vjp = jax.vjp(lambda a, b, c: JL._sdpa(a, b, c, causal=causal,
                                              scale=scale), jq, jk, jv)
    for g, j in zip(got, vjp(jdo)):
        _close_normwise(g.transpose(1, 2), j, 1e-5)


@pytest.mark.parametrize("wrong", ["small terms dropped", "Di left out",
                                   "mask one key late",
                                   "kv heads interleaved",
                                   "last slice dropped"])
@pytest.mark.parametrize("S,T", [(100, 100), (150, 150)])
def test_flash_fp32_tf32_emulation_fails_each_wrong_kernel(wrong, S, T):
    """Each one-edit wrong split-TF32 backward of tests/test_torch_gpu.py
    (FLASH_BWD_MUTANTS_TF32), emulated, misses autograd of the plain
    version by more than chip_smoke's fp32 backward check allows, at a
    causal GQA-4 layout on both designs: one block a head (T = 100) and
    key tiles with the dQ kernel (T = 150 at D = 128)."""
    smoke = _smoke()
    D = 64 if T <= 128 else 128
    _, want, (qh, kh, vh, _, doh) = _tf32_case(15, 1, S, T, 8, 2, D, True)
    scale = D ** -0.5
    o, lse = _flash_fwd_tf32(qh, kh, vh, scale=scale, causal=True)
    how = "single" if wrong == "small terms dropped" else "split"
    *got, _ = _flash_bwd_tf32(qh, kh, vh, o, doh, lse, scale=scale,
                              causal=True, how=how, wrong=wrong)
    err, ok, tol = smoke.check_normwise([g.transpose(1, 2) for g in got],
                                        want, "float32")
    assert not ok, (wrong, err, tol)


# ---------------------------------------------------------------------------
# the RMSNorm backward's design: csrc/rmsnorm.cu rmsnorm_bwd_kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,D", [(37, 128), (1024, 64), (5, 300),
                                    (140, 8200)])
def test_rmsnorm_bwd_formula_and_block_partials_match_autograd(rows, D):
    """dx = r (g s - xh mean(g s xh)) per row, and dscale summed as the
    kernels sum it: block b walks row groups b, b + blocks, ... (each
    ``rows_per_block`` rows, one a lane group), each lane group adds its
    rows in order, the block's groups meet in group order in one partial
    row; then the dscale pass's warp w sums partial rows w, w + 8, ... in
    order and the 8 warps' sums are added in warp order."""
    rng = np.random.default_rng(9)
    x, gy = (torch.from_numpy(rng.standard_normal((rows, D)).astype(
        np.float32)) for _ in range(2))
    s = torch.from_numpy((1 + 0.1 * rng.standard_normal(D)).astype(
        np.float32))
    xa, sa = x.clone().requires_grad_(), s.clone().requires_grad_()
    tref.rmsnorm_ref(xa, sa).backward(gy)
    r = torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
    xh = x * r
    dx = r * (gy * s - xh * (gy * s * xh).mean(-1, keepdim=True))
    _, _, rows_per_block, _ = trn.bwd_launch_shape(D, 4)
    blocks = trn.bwd_blocks(rows, rows_per_block)
    groups = torch.zeros((blocks, rows_per_block, D))
    for g0 in range(0, rows, rows_per_block):
        for sub in range(min(rows_per_block, rows - g0)):
            row = g0 + sub
            groups[(g0 // rows_per_block) % blocks, sub] += gy[row] * xh[row]
    partial = torch.zeros((blocks, D))
    for sub in range(rows_per_block):
        partial += groups[:, sub]
    warps = torch.zeros((8, D))
    for b in range(blocks):
        warps[b % 8] += partial[b]
    dscale = torch.zeros(D)
    for w in range(8):
        dscale += warps[w]
    torch.testing.assert_close(dx, xa.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dscale, sa.grad, rtol=1e-5, atol=1e-5)


def test_rmsnorm_bwd_blocks_are_a_function_of_the_shape():
    """One block an SM of an H100 at most, whatever card runs it; at the
    train step's (1024, 4096) bf16 norms (2 rows a block) every SM walks
    about 4 row groups."""
    assert trn.bwd_launch_shape(4096, 2)[2] == 2
    assert trn.bwd_blocks(1, 32) == 1
    assert trn.bwd_blocks(100, 2) == 50
    assert trn.bwd_blocks(1024, 2) == trn.BWD_MAX_BLOCKS == 132
    assert trn.bwd_blocks(32768, 32) == trn.BWD_MAX_BLOCKS


def test_rmsnorm_bwd_launch_shape_covers_every_width_once():
    """The backward's shape for every width of ``RMSNORM_WIDTHS`` and both
    item sizes: the row covered once, at most 4 vectors of 16 bytes a lane
    (8 single elements), a block of max(256, lanes) threads whose row
    groups' dscale sums (a block of several rows) fit the shared memory
    csrc/rmsnorm.cu allows them (kMaxSmemBwd), vector groups no wider than
    its backward build (kMaxVecSpanBwd), and the looped body past 16,384
    (8,192 in elements)."""
    import re
    src = (build.CSRC / "rmsnorm.cu").read_text()
    span = int(re.search(r"constexpr int kMaxVecSpanBwd = (\d+);", src)[1])
    smem = int(re.search(r"constexpr int kMaxSmemBwd = (\d+) << 10;",
                         src)[1]) << 10
    assert re.search(r"return VEC > 1 \? (\d+) : (\d+);", src).groups() == (
        str(trn.BWD_MAX_VECS_PER_LANE), str(trn.MAX_VECS_PER_LANE))
    assert span == trn.BWD_MAX_VEC_SPAN
    for itemsize in (2, 4):
        for D in RMSNORM_WIDTHS:
            shape = trn.bwd_launch_shape(D, itemsize)
            lanes, nv, rows, vec = shape
            assert vec == trn.launch_shape(D, itemsize)[3]
            _rmsnorm_covered(shape, D, itemsize, trn.BWD_MAX_VECS_PER_LANE
                             if vec > 1 else trn.MAX_VECS_PER_LANE, span)
            assert rows == 1 or 4 * rows * D <= smem, (D, itemsize)


# ---------------------------------------------------------------------------
# the SSD scan's gradient: the plain scan's repaired mask, and the backward
# kernel's phases emulated in plain torch
# ---------------------------------------------------------------------------

def _ssd_scan_ref_select_after_exp(x, Bm, Cm, dt, a, *, chunk):
    """``ref.ssd_scan_ref`` as it was before its mask moved ahead of the
    exp (no h0): ``where(tri, exp(seg), 0)``.  Same forward; its gradient
    is NaN once exp(seg) overflows above the diagonal."""
    Bsz, S, H, P = x.shape
    G = Bm.shape[2]
    Q = min(chunk, S)
    assert S % Q == 0
    head_group = torch.arange(H) // (H // G)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    h = torch.zeros((Bsz, H, P, Bm.shape[3]))
    ys = []
    for c0 in range(0, S, Q):
        x_c, B_c, C_c = (t[:, c0:c0 + Q] for t in (x, Bm, Cm))
        dt_c, a_c = dt[:, c0:c0 + Q], a[:, c0:c0 + Q]
        cum = torch.cumsum(a_c, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        decay = torch.where(tri[None, :, :, None], torch.exp(seg),
                            torch.zeros(()))
        cb = torch.einsum("bign,bjgn->bijg", C_c, B_c)[..., head_group]
        y = torch.einsum("bijh,bjhp->bihp", cb * decay * dt_c[:, None], x_c)
        Ch, Bh = C_c[:, :, head_group], B_c[:, :, head_group]
        y = y + torch.einsum("bqhn,bhpn->bqhp", Ch, h) * \
            torch.exp(cum)[..., None]
        dec_end = torch.exp(cum[:, -1:, :] - cum)
        bx = torch.einsum("bqh,bqhp,bqhn->bhpn", dec_end * dt_c, x_c, Bh)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + bx
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssd_grad_case(seed, B, S, H, P, N, G, *, decay=None, h0=False,
                   dh_final=True):
    """Inputs, h0, dy and dh_final drawn with numpy (``_ssd_inputs``);
    ``decay`` set, a = decay on every row (strong decay: exp(cum_i -
    cum_j) overflows above the diagonal within a chunk)."""
    x, Bm, Cm, dt, a = _ssd_inputs(seed, B, S, H, P, N, G)
    if decay is not None:
        a = np.full_like(a, decay)
    rng = np.random.default_rng(seed + 100)
    hh = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if h0 else None)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if dh_final else None)
    return (x, Bm, Cm, dt, a), hh, dy, dh


def _ssd_torch_grads(fn, arrays, hh, dy, dh, **kw):
    """Autograd of sum(y·dy) + sum(h_final·dh) through ``fn`` -> grads of
    (x, Bm, Cm, dt, a[, h0])."""
    ins = [torch.from_numpy(t).requires_grad_() for t in arrays]
    if hh is not None:
        ins.append(torch.from_numpy(hh).requires_grad_())
        kw["h0"] = ins[-1]
    y, hf = fn(*ins[:5], **kw)
    loss = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        loss = loss + (hf * torch.from_numpy(dh)).sum()
    return torch.autograd.grad(loss, ins)


def test_ssd_scan_ref_masks_before_the_exp():
    """a = -3 on every row of one 64-row chunk: cum falls to -192, so
    exp(cum_i - cum_j) overflows above the diagonal.  The repaired plain
    scan's forward equals the old select-after-exp form bit for bit; the
    old form's grad of a is NaN (0 · inf in the select's backward), the
    repaired one's is finite and equals jax.grad of the sequential
    recurrence, which forms no exp(seg), at 1e-5 of its scale.  The
    forwards are compared on one CPU thread: with several, the CPU's
    multi-threaded sums may differ in the last bit between two runs of
    the same function."""
    arrays, _, dy, dh = _ssd_grad_case(20, 1, 64, 4, 8, 16, 1, decay=-3.0)
    assert 3.0 * 64 > np.log(np.finfo(np.float32).max)
    ts = [torch.from_numpy(t) for t in arrays]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        new = tref.ssd_scan_ref(*ts, chunk=64)
        old = _ssd_scan_ref_select_after_exp(*ts, chunk=64)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    g_old = _ssd_torch_grads(_ssd_scan_ref_select_after_exp, arrays, None,
                             dy, dh, chunk=64)
    assert not torch.isfinite(g_old[4]).all()          # grad a: NaN
    assert torch.isfinite(g_old[0]).all()              # grad x stays finite
    got = _ssd_torch_grads(tref.ssd_scan_ref, arrays, None, dy, dh, chunk=64)
    assert all(torch.isfinite(g).all() for g in got)

    def seq(x, Bm, Cm, dt, a):
        y, hf = jref.ssd_scan_ref(x, Bm, Cm, dt, a)
        return jnp.sum(y * dy) + jnp.sum(hf * dh)
    want = jax.grad(seq, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in arrays))
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-5)


@pytest.mark.parametrize("B,S,H,P,N,G,chunk,decay,h0", [
    (2, 64, 4, 16, 8, 1, 16, None, False),
    (1, 100, 4, 8, 16, 2, 32, None, True),     # ragged, two groups, h0
    (1, 128, 2, 8, 8, 1, 64, -3.0, False),     # strong decay: vs sequential
    (1, 96, 4, 8, 16, 2, 32, -2.0, True),
])
def test_ssd_scan_ref_grads_match_jax_grad(B, S, H, P, N, G, chunk, decay,
                                           h0):
    """fp32 grads of the plain scan (x, Bm, Cm, dt, a, h0) at 1e-5 of
    each one's scale: at mild decay against jax.grad of the reference's
    chunked ``_ssd_chunked``; at strong decay, where that one's own grad
    is NaN (its select after the exp, ROADMAP Queue 3), against jax.grad
    of the sequential recurrence ``repro.kernels.ref.ssd_scan_ref``."""
    arrays, hh, dy, dh = _ssd_grad_case(21, B, S, H, P, N, G, decay=decay,
                                        h0=h0)
    got = _ssd_torch_grads(tref.ssd_scan_ref, arrays, hh, dy, dh,
                           chunk=chunk)
    cfg = JM2.Mamba2Config(d_model=H * P // 2, d_state=N, head_dim=P,
                           n_groups=G, chunk=chunk)
    hg = np.arange(H) // (H // G)

    def loss(x, Bm, Cm, dt, a, *h):
        if decay is None:
            y, hf = JM2._ssd_chunked(cfg, x, Bm, Cm, (dt, a), *h)
        else:
            y, hf = jref.ssd_scan_ref(x, Bm[:, :, hg], Cm[:, :, hg], dt, a,
                                      *h)
        return jnp.sum(y * dy) + jnp.sum(hf * dh)
    jin = [jnp.asarray(t) for t in arrays] + (
        [] if hh is None else [jnp.asarray(hh)])
    want = jax.grad(loss, argnums=tuple(range(len(jin))))(*jin)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close_scaled(g, w, 1e-5)


def _ssd_bwd_phases(x, Bm, Cm, dt, a, h0, dy, dh_final, *, chunk,
                    wrong=None):
    """csrc/ssd_scan_bwd.cu's four phases in plain torch, fp32, in its
    order: (a) each chunk's cum, own state s_c and u_c = Σ_i exp(cum_i)
    dy_i⊗C_i; (b) the states entering each chunk from h0, then the state
    gradients leaving each chunk from dh_final, down to dh0; (c) each
    chunk's gradients per head from K = CB·L and D = dS·L, selected
    below the diagonal, dcum from its three sources and da its reverse
    cumsum; (d) dB, dC summed over each group's heads in head order.
    ``wrong`` makes one of the card's wrong kernels: "drop_mask" (L not
    selected), "exp_product" (L as exp(cum_i)·exp(-cum_j)),
    "no_revcumsum" (da = dcum), "one_head" (each group's dB, dC from its
    first head).  -> (dx, dB, dC, ddt, da, dh0)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    x, Bm, Cm, dt, a, dy = (t.float() for t in (x, Bm, Cm, dt, a, dy))
    if pad:
        x, Bm, Cm, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (x, Bm, Cm, dy))
        dt, a = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, a))
    hpg = H // G
    hg = torch.arange(H) // hpg
    Bh, Ch = Bm[:, :, hg], Cm[:, :, hg]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :, None]

    def ch(t, c):
        return t[:, c * Q:(c + 1) * Q]
    # (a)
    cums, st, ut = [], [], []
    for c in range(nc):
        cum = torch.cumsum(ch(a, c), 1)
        edec = torch.exp(cum[:, -1:] - cum)
        st.append(torch.einsum("bqh,bqhp,bqhn->bhpn", edec * ch(dt, c),
                               ch(x, c), ch(Bh, c)))
        ut.append(torch.einsum("bqh,bqhp,bqhn->bhpn", torch.exp(cum),
                               ch(dy, c), ch(Ch, c)))
        cums.append(cum)
    # (b)
    h = torch.zeros((Bsz, H, P, N)) if h0 is None else h0.float()
    hin = []
    for c in range(nc):
        hin.append(h)
        h = torch.exp(cums[c][:, -1])[..., None, None] * h + st[c]
    dh = torch.zeros((Bsz, H, P, N)) if dh_final is None else \
        dh_final.float()
    dhout = [None] * nc
    for c in reversed(range(nc)):
        dhout[c] = dh
        dh = torch.exp(cums[c][:, -1])[..., None, None] * dh + ut[c]
    # (c)
    grads = [torch.zeros_like(t) for t in (x, Bh, Ch, dt, a)]
    for c in range(nc):
        cum, hh, dhh = cums[c], hin[c], dhout[c]
        cl = cum[:, -1]
        xc, Bc, Cc, dtc, dyc = (ch(t, c) for t in (x, Bh, Ch, dt, dy))
        seg = cum[:, :, None] - cum[:, None]
        if wrong == "exp_product":
            L = torch.where(tri, torch.exp(cum)[:, :, None] *
                            torch.exp(-cum)[:, None], torch.zeros(()))
        elif wrong == "drop_mask":
            L = torch.exp(seg)
        else:
            L = torch.exp(seg.masked_fill(~tri, float("-inf")))
        K = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * L
        dS = torch.einsum("bihp,bjhp->bijh", dyc, xc)
        D = dS * L
        E = K * dS
        edec, ecum = torch.exp(cl[:, None] - cum), torch.exp(cum)
        dhB = torch.einsum("bjhn,bhpn->bjhp", Bc, dhh)
        dxc = dtc[..., None] * (torch.einsum("bijh,bihp->bjhp", K, dyc)
                                + edec[..., None] * dhB)
        dds = edec * (xc * dhB).sum(-1)
        dBc = dtc[..., None] * (
            torch.einsum("bijh,bihn->bjhn", D, Cc) + edec[..., None] *
            torch.einsum("bjhp,bhpn->bjhn", xc, dhh))
        hdy = torch.einsum("bihp,bhpn->bihn", dyc, hh)
        dCc = torch.einsum("bijh,bjh,bjhn->bihn", D, dtc, Bc) + \
            ecum[..., None] * hdy
        ddtc = E.sum(1) + dds
        dcum = (E * dtc[:, None]).sum(2) - dtc * ddtc + \
            ecum * (Cc * hdy).sum(-1)
        dcum[:, -1] += (dtc * dds).sum(1) + torch.exp(cl) * \
            (dhh * hh).sum((-1, -2))
        dac = dcum if wrong == "no_revcumsum" else \
            dcum.flip(1).cumsum(1).flip(1)
        for gr, v in zip(grads, (dxc, dBc, dCc, ddtc, dac)):
            gr[:, c * Q:(c + 1) * Q] = v
    dx, dBh, dCh, ddt, da = grads
    # (d)
    dB = torch.zeros((Bsz, nc * Q, G, N))
    dC = torch.zeros_like(dB)
    for g in range(G):
        for k in range(1 if wrong == "one_head" else hpg):
            dB[:, :, g] += dBh[:, :, g * hpg + k]
            dC[:, :, g] += dCh[:, :, g * hpg + k]
    return (dx[:, :S], dB[:, :S], dC[:, :S], ddt[:, :S], da[:, :S], dh)


def _ssd_bwd_phase_errs(case, chunk, wrong=None):
    """(relative max error of each gradient of the emulated kernel against
    autograd through the plain scan)."""
    arrays, hh, dy, dh = case
    want = _ssd_torch_grads(tref.ssd_scan_ref, arrays, hh, dy, dh,
                            chunk=chunk)
    ts = [torch.from_numpy(t) for t in arrays]
    got = _ssd_bwd_phases(*ts, None if hh is None else torch.from_numpy(hh),
                          torch.from_numpy(dy),
                          None if dh is None else torch.from_numpy(dh),
                          chunk=chunk, wrong=wrong)
    return [float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("B,S,H,P,N,G,chunk,h0,dh_final,decay", [
    (2, 64, 4, 16, 8, 1, 16, False, False, None),
    (1, 100, 4, 8, 16, 2, 32, True, True, None),    # ragged, G = 2
    (2, 37, 6, 8, 8, 3, 64, True, False, None),     # S < Q, three groups
    (1, 130, 4, 8, 16, 1, 64, True, True, -3.0),    # strong decay, ragged
])
def test_ssd_bwd_phases_match_autograd_of_the_plain_scan(
        B, S, H, P, N, G, chunk, h0, dh_final, decay):
    """The backward kernel's algebra, phase by phase (``_ssd_bwd_phases``),
    equals autograd through the repaired plain scan for every gradient
    (x, B, C, dt, a, h0) at 1e-5 of its scale, fp32."""
    case = _ssd_grad_case(22, B, S, H, P, N, G, decay=decay, h0=h0,
                          dh_final=dh_final)
    errs = _ssd_bwd_phase_errs(case, chunk)
    assert len(errs) == (6 if h0 else 5)
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("wrong", ["drop_mask", "exp_product",
                                   "no_revcumsum", "one_head"])
def test_ssd_bwd_emulation_fails_each_wrong_kernel(wrong):
    """Each one-edit wrong backward kernel, emulated, misses autograd
    through the plain scan by far more than the card's fp32 check allows
    (1e-4 of max |grad|), or goes NaN: at strong decay (a = -3 a row,
    64-row chunks) with two groups of two heads, h0 and dh_final."""
    case = _ssd_grad_case(23, 1, 130, 4, 8, 16, 2, decay=-3.0, h0=True)
    assert max(_ssd_bwd_phase_errs(case, 64)) <= 1e-5
    errs = _ssd_bwd_phase_errs(case, 64, wrong)
    bad = [e for e in errs if not e <= 10 * _smoke().BWD_TOL["float32"]]
    assert bad, errs


# ---------------------------------------------------------------------------
# the bf16 backward kernel's arithmetic, emulated: its head slices, the
# group's Q x Q products once a slice, and each fp32 factor as hi + lo
# ---------------------------------------------------------------------------

# the fp32 factors of the bf16 backward kernel's products
SSD_BWD_FACTORS = ("dy", "K", "Mbar", "dh", "xs", "dye", "h", "w")


def _terms(v: torch.Tensor, how: str | None) -> list:
    """A factor as the bf16 tensor cores take it: a bf16 input as it is
    (``how`` None), an fp32 one as [hi, lo] ("hilo"), [hi] ("single") or
    unchanged ("fp32")."""
    if how in (None, "fp32"):
        return [v]
    hi = v.to(torch.bfloat16).float()
    return [hi] if how == "single" else [hi, (v - hi).to(torch.bfloat16)
                                         .float()]


def _mm(eq: str, a, b, how_a, how_b):
    """einsum ``eq`` of a and b as the kernel takes the product: the terms
    of each factor, lo·lo left out where both are split (hi·hi + hi·lo +
    lo·hi)."""
    out = 0
    for i, u in enumerate(_terms(a, how_a)):
        for j, w in enumerate(_terms(b, how_b)):
            if i + j < 2:
                out = out + torch.einsum(eq, u, w)
    return out


def _ssd_bwd_slices(B, H, G, S, Q):
    """The head slices of a group in the bf16 kernel (``head_slices`` in
    csrc/ssd_scan_bwd.cu): as many as fill one wave of 132 blocks (the
    H100 SXM's SMs, fixed there so that the slicing is a function of the
    shape), one head each at most."""
    return max(1, min(132 // (B * G * -(-S // Q)), H // G))


def _ssd_bwd_tc(x, Bm, Cm, dt, a, h0, dy, dh_final, *, chunk, slices=None,
                how=None):
    """csrc/ssd_scan_bwd.cu's bf16 body in plain torch, fp32 sums, in its
    tiling: (a) each chunk's s_c = w^T B and u_c = (exp(cum) dy)^T C; (b)
    the serial passes; (c) for each (b, chunk, group, slice of the group's
    heads), its heads in order: dS^T = x dy^T, K^T = CB^T o L^T, dx =
    dt o (edec o B dh^T + K^T dy), ddt and dcum from E^T = K^T o dS^T, and
    Mbar^T += diag(dt) D^T; then the slice's dB = Mbar^T C + sum_h xs_h
    dh_h and dC = Mbar B + sum_h dye_h h_h (xs = dt edec x, dye = exp(cum)
    dy), dcum's state term exp(cum_i) dy_i . (C h^T)_i, da its reverse
    cumsum; (d) the slices' dB, dC summed in slice order, cast to x's
    type.  ``slices``: the slices a group is cut into (the kernel's
    ``_ssd_bwd_slices`` when None).  ``how`` maps a factor of SSD_BWD_FACTORS to "hilo" (the
    kernel's, the default), "single" or "fp32".  -> (dx, dB, dC, ddt, da,
    dh0)."""
    how = {f: "hilo" for f in SSD_BWD_FACTORS} | (how or {})
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    out_dtype = x.dtype
    x, Bm, Cm, dt, a, dy = (t.float() for t in (x, Bm, Cm, dt, a, dy))
    if pad:
        x, Bm, Cm, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (x, Bm, Cm, dy))
        dt, a = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (dt, a))
    hpg = H // G
    hg = torch.arange(H) // hpg
    xc, dyc = (t.reshape(Bsz, nc, Q, H, P) for t in (x, dy))
    Bc, Cc = (t.reshape(Bsz, nc, Q, G, N) for t in (Bm, Cm))
    Bh, Ch = Bc[:, :, :, hg], Cc[:, :, :, hg]               # (B,nc,Q,H,N)
    dtc, ac = (t.reshape(Bsz, nc, Q, H) for t in (dt, a))
    cum = torch.cumsum(ac, dim=2)                           # row order
    cl = cum[:, :, -1]                                      # (B,nc,H)
    ecum, edec = torch.exp(cum), torch.exp(cl[:, :, None] - cum)
    # (a)
    w = (edec * dtc)[..., None] * xc
    dye = ecum[..., None] * dyc
    st = _mm("bcqhp,bcqhn->bchpn", w, Bh, how["w"], None)
    ut = _mm("bcqhp,bcqhn->bchpn", dye, Ch, how["dye"], None)
    # (b)
    hs = torch.zeros((Bsz, H, P, N)) if h0 is None else h0.float()
    hin = []
    for c in range(nc):
        hin.append(hs)
        hs = torch.exp(cl[:, c])[..., None, None] * hs + st[:, c]
    dh = torch.zeros((Bsz, H, P, N)) if dh_final is None else \
        dh_final.float()
    dhl = [None] * nc
    for c in reversed(range(nc)):
        dhl[c] = dh
        dh = torch.exp(cl[:, c])[..., None, None] * dh + ut[:, c]
    hin, dhl = torch.stack(hin, 1), torch.stack(dhl, 1)     # (B,nc,H,P,N)
    # (c): rows j of every Q x Q matrix, columns i
    rows = torch.arange(Q)
    valid = torch.arange(nc)[:, None] * Q + rows[None] < S  # (nc,Q): i < q
    sel = (rows[:, None] <= rows[None, :])[None] & valid[:, None, :]
    seg = cum[:, :, None, :, :] - cum[:, :, :, None, :]     # [j,i] = ci-cj
    Lt = torch.exp(seg.masked_fill(~sel[None, :, :, :, None],
                                   float("-inf")))          # (B,nc,Q,Q,H)
    CBt = torch.einsum("bcjgn,bcign->bcjig", Bc, Cc)[..., hg]
    Kt = CBt * Lt
    dSt = _mm("bcjhp,bcihp->bcjih", xc, dyc, None, how["dy"])
    Bdh = _mm("bcjhn,bchpn->bcjhp", Bh, dhl, None, how["dh"])
    dds = edec * (xc * Bdh).sum(-1)
    dx = dtc[..., None] * (edec[..., None] * Bdh +
                           _mm("bcjih,bcihp->bcjhp", Kt, dyc, how["K"],
                               how["dy"]))
    Dt = dSt * Lt
    Et = CBt * Dt
    ddt = Et.sum(3) + dds
    dcum = (Et * dtc[:, :, :, None]).sum(2) - dtc * ddt
    T = _mm("bcihn,bchpn->bcihp", Ch, hin, None, how["h"])
    dcum = dcum + ecum * (dyc * T).sum(-1)
    last = (dtc * dds).sum(2) + torch.exp(cl) * (dhl * hin).sum((-1, -2))
    qlast = (S - 1) % Q
    dcum[:, :, Q - 1] += last
    if pad:                                  # the ragged chunk's last row
        dcum[:, -1, qlast] += last[:, -1]
        dcum[:, -1, Q - 1] -= last[:, -1]
    da = dcum.flip(2).cumsum(2).flip(2)
    # (c) dB and dC of each slice, (d) their sum in slice order
    Mt = dtc[:, :, :, None] * Dt                            # (B,nc,j,i,H)
    xs = (dtc * edec)[..., None] * xc
    dB = torch.zeros((Bsz, nc, Q, G, N))
    dC = torch.zeros_like(dB)
    ns = _ssd_bwd_slices(Bsz, H, G, S, Q) if slices is None else \
        min(hpg, slices)
    for g in range(G):
        for s in range(ns):
            heads = range(g * hpg + s * hpg // ns,
                          g * hpg + (s + 1) * hpg // ns)
            mbar = torch.zeros((Bsz, nc, Q, Q))
            for h in heads:                  # head order
                mbar = mbar + Mt[..., h]
            pb = _mm("bcji,bcin->bcjn", mbar, Cc[:, :, :, g], how["Mbar"],
                     None)
            pc = _mm("bcji,bcjn->bcin", mbar, Bc[:, :, :, g], how["Mbar"],
                     None)
            for h in heads:
                pb = pb + _mm("bcjp,bcpn->bcjn", xs[:, :, :, h],
                              dhl[:, :, h], how["xs"], how["dh"])
                pc = pc + _mm("bcip,bcpn->bcin", dye[:, :, :, h],
                              hin[:, :, h], how["dye"], how["h"])
            dB[:, :, :, g] += pb
            dC[:, :, :, g] += pc

    def rows_(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]
    return (rows_(dx).to(out_dtype), rows_(dB).to(out_dtype),
            rows_(dC).to(out_dtype), rows_(ddt), rows_(da),
            None if h0 is None else dh)


@pytest.mark.parametrize("B,S,H,P,N,G,chunk,slices,h0,dh_final,decay", [
    (2, 64, 4, 16, 8, 1, 16, 8, False, False, None),
    (1, 100, 6, 8, 16, 2, 32, 2, True, True, None),   # ragged, 3 / 2 slices
    (2, 37, 6, 8, 8, 3, 64, 8, True, False, None),    # S < Q, three groups
    (1, 130, 8, 8, 16, 1, 64, 3, True, True, -3.0),   # strong decay, 8 / 3
])
def test_ssd_bwd_tc_algebra_matches_autograd_in_fp32(B, S, H, P, N, G, chunk,
                                                     slices, h0, dh_final,
                                                     decay):
    """The bf16 backward kernel's tiling (``_ssd_bwd_tc``: dB and dC from
    Mbar summed over each head slice, the state terms added per head,
    slices summed in order, heads that do not divide evenly into slices)
    with every factor unrounded equals autograd through the plain scan for
    every gradient at 1e-5 of its scale, fp32."""
    arrays, hh, dy, dh = _ssd_grad_case(24, B, S, H, P, N, G, decay=decay,
                                        h0=h0, dh_final=dh_final)
    want = _ssd_torch_grads(tref.ssd_scan_ref, arrays, hh, dy, dh,
                            chunk=chunk)
    ts = [torch.from_numpy(t) for t in arrays]
    got = _ssd_bwd_tc(*ts, None if hh is None else torch.from_numpy(hh),
                      torch.from_numpy(dy),
                      None if dh is None else torch.from_numpy(dh),
                      chunk=chunk, slices=slices,
                      how={f: "fp32" for f in SSD_BWD_FACTORS})
    got = [g for g in got if g is not None]
    assert len(got) == len(want) == (6 if h0 else 5)
    for g, w in zip(got, want):
        _close_scaled(g, w.numpy(), 1e-5)


def _ssd_bwd_mamba2_case():
    """mamba2-780m's widths (48 heads of 64, d_state 128, chunk 128) with
    two groups, three chunks (S = 300), h0 and dh_final, bf16 inputs and
    the decays of the card's mutant tests (dt = softplus(N(0, 1)), A =
    -(1..H)); -> (inputs, autograd's grads through the plain scan)."""
    rng = np.random.default_rng(7)
    B, S, H, P, N, G = 1, 300, 48, 64, 128, 2

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    x, Bm, Cm = (randn(*s).to(torch.bfloat16)
                 for s in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
    dt = torch.nn.functional.softplus(randn(B, S, H))
    a = dt * -torch.arange(1, H + 1, dtype=torch.float32)
    h0, dy, dh = randn(B, H, P, N), randn(B, S, H, P), randn(B, H, P, N)
    ins = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, a, h0)]
    y, hf = tref.ssd_scan_ref(*ins, chunk=128)
    want = torch.autograd.grad((y, hf), ins, (dy, dh))
    return (x, Bm, Cm, dt, a, h0, dy, dh), want


_SSD_BWD_MAMBA2 = []


@pytest.mark.parametrize("rounded_once", [None, *SSD_BWD_FACTORS])
def test_ssd_bwd_bf16_rounding_each_fp32_factor_once(rounded_once):
    """The bf16 backward kernel's arithmetic (``_ssd_bwd_tc``) at
    mamba2-780m's widths (``_ssd_bwd_mamba2_case``) against autograd
    through the plain scan, held by chip_smoke.py's ``check_ssd_bwd``:
    every gradient within BWD_TOL (2e-2) of max |grad|, and ddt, da and
    dh0, which stay fp32, within SSD_BWD_F32_TOL (1e-4).  With every fp32
    factor split into bf16 hi + lo (the kernel's) it passes: ddt 2.4e-6,
    da 1.6e-6, dh0 2.6e-6 of max |grad| (dx, dB, dC 1.1e-3 to 2.4e-3,
    their own bf16 rounding).  Rounding one factor to bf16 once instead:
    dy, dh, dye, h and w fail (the largest of ddt, da, dh0 reads 2.4e-3,
    1.7e-4, 1.7e-3, 5.0e-4 and 3.4e-4 of max |grad|); K, Mbar and xs
    still pass (they reach only dx, dB and dC, which move to at most
    4.7e-3, inside BWD_TOL).  Every gradient stays within BWD_TOL either
    way.  The kernel keeps every lo term: nothing shows that the phase-9
    grad check is unmoved without K's, Mbar's or xs's."""
    check = _smoke().check_ssd_bwd
    if not _SSD_BWD_MAMBA2:
        _SSD_BWD_MAMBA2.append(_ssd_bwd_mamba2_case())
    ins, want = _SSD_BWD_MAMBA2[0]
    how = {} if rounded_once is None else {rounded_once: "single"}
    got = _ssd_bwd_tc(*ins, chunk=128, how=how)
    err, ok, tol = check(got, want, "bfloat16")
    loose = _smoke()._normwise(got, want, _smoke().BWD_TOL["bfloat16"])[1]
    assert loose, (rounded_once, err)
    fails = {"dy", "dh", "dye", "h", "w"}
    assert ok == (rounded_once not in fails), (rounded_once, err, tol)

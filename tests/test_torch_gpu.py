"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test that runs a kernel is marked ``gpu`` and skips without a CUDA
device: the kernels have no CPU mode (only the check that each wrong-kernel
edit applies to its source runs anywhere).  The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch and the
CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (``atol + rtol * |plain|``): kernel and plain version both
compute in fp32, so fp32 differs only by summation order (2e-5); bf16
outputs may differ by one rounding step of 8 significant bits, at most 2^-7
of the value.  The SSD scan's outputs are fp32 in both dtypes and are held
by chip_smoke.py's own ``check_ssd`` (1e-4 of each output's max |value|).
The backward kernels are held by chip_smoke.py's ``check_normwise``
against autograd through the plain versions (1e-4 of each gradient's max
|value| in fp32, 2e-2 in bf16).
"""
import importlib.util
import math
import pathlib
import subprocess

import pytest
import torch

from repro_torch import tree
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tssd

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"float32": (torch.float32, 2e-5, 2e-5),
          "bfloat16": (torch.bfloat16, 1e-5, 2.0 ** -7)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _smoke():
    """chip_smoke.py as a module: its checks and input makers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# rows past 8,192: command-r-plus-104b's d_model on the register-held body
# (a decode step's rows and a forward's), an odd width on the looped body in
# single elements, and a vector width past the register-held 16,384
RMSNORM_WIDE_SHAPES = [(4, 12288), (1024, 12288), (5, 12289), (3, 16392)]
# llama-3.2-vision-90b's d_model: its forward's, prefill chunk's and
# decode step's rows
RMSNORM_VISION_SHAPES = [(1024, 8192), (256, 8192), (4, 8192)]


# the paper's ViTs, bidirectional at head dim 64: ViT-B on CIFAR-100's
# 8 x 8 patches + cls (65 tokens), ViT-B/16 at 224 (197 tokens)
VIT_FLASH_CASES = [(2, 65, 65, 12, 12, 64, False),
                   (1, 197, 197, 12, 12, 64, False)]
# the fp32 split-TF32 bodies' edges (bf16 runs them too): one row, a
# slice and a row, exactly five slices, S != T both ways, causal and not,
# GQA and MQA, at every head dim they take, and both backward designs (one
# block a head up to 208 keys, 64 at D = 128; key tiles and the dQ kernel
# past that)
TF32_FLASH_CASES = [
    (3, 1, 65, 4, 4, 64, False),       # one row
    (2, 1, 1, 4, 2, 16, True),         # one row, one key
    (2, 17, 17, 8, 2, 32, True),       # GQA 4: a slice and a row
    (2, 17, 90, 4, 4, 128, False),
    (4, 80, 80, 6, 6, 64, False),      # exactly five 16-row slices
    (2, 80, 33, 4, 1, 16, True),       # S > T, MQA
    (2, 65, 197, 8, 2, 64, True),      # S < T, GQA 4, past one block
    (1, 197, 65, 4, 4, 32, False),
    (1, 197, 197, 4, 4, 128, True),
    (1, 150, 300, 4, 2, 32, False),    # past 208 keys: key tiles + dQ
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(3, 4096), (37, 128), (5, 7, 300),
                                   (2, 8192), *RMSNORM_WIDE_SHAPES,
                                   *RMSNORM_VISION_SHAPES])
def test_cuda_rmsnorm_matches_plain(shape, dtype):
    _need_cuda()
    tdt, atol, rtol = DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(tdt)
    s = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
    before = trn.rmsnorm.launches
    got = trn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert trn.rmsnorm.launches == before + 1
    torch.testing.assert_close(got.float(), tref.rmsnorm_ref(x, s).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", [
    (2, 128, 128, 4, 2, 128, True),
    (1, 300, 300, 4, 1, 64, True),
    (1, 100, 260, 2, 2, 32, True),
    (1, 260, 100, 2, 2, 16, True),
    (2, 77, 130, 4, 2, 128, False),
    (1, 2048, 2048, 4, 2, 128, True),
    (1, 129, 1, 4, 2, 128, True),      # one key, one row past a 128-tile
    (1, 300, 300, 32, 32, 160, True),  # zamba2-2.7b's shared block
    (1, 300, 300, 16, 16, 256, True),  # gemma-7b
    (2, 384, 384, 16, 16, 64, True),   # whisper-medium's decoder forward
    (2, 512, 512, 64, 8, 128, True),   # llama-3.2-vision-90b: GQA 8
    *VIT_FLASH_CASES,
    *TF32_FLASH_CASES,
])
def test_cuda_flash_attention_matches_plain(B, S, T, H, Hkv, D, causal,
                                            dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, atol, rtol = DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(tdt)
    k = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(tdt)
    v = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(tdt)
    before = tfa.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tref.flash_attention_ref(q, k, v, scale=D ** -0.5, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(3, 4096), (37, 128), (5, 7, 300),
                                   (1024, 4096), (2, 8192),
                                   *RMSNORM_WIDE_SHAPES])
def test_cuda_rmsnorm_bwd_matches_plain(shape, dtype):
    """dx and dscale through RMSNormFn (the backward kernel) against
    autograd through the plain version."""
    _need_cuda()
    smoke = _smoke()
    tdt = DTYPES[dtype][0]
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=g, device="cuda").to(tdt)
    s = (1.0 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
         ).to(tdt)
    gy = torch.randn(shape, generator=g, device="cuda").to(tdt)
    xk, sk = x.clone().requires_grad_(), s.clone().requires_grad_()
    before = (trn.rmsnorm.launches, trn.rmsnorm_bwd.launches)
    trn.rmsnorm(xk, sk).backward(gy)
    torch.cuda.synchronize()
    assert (trn.rmsnorm.launches, trn.rmsnorm_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    tref.rmsnorm_ref(xr, sr).backward(gy)
    assert xk.grad.dtype == tdt and sk.grad.dtype == tdt
    err, ok, tol = smoke.check_normwise((xk.grad, sk.grad),
                                        (xr.grad, sr.grad), dtype)
    assert ok, (err, tol)


# the split-row RMSNorm (mamba2's gated norm under tensor parallelism):
# mamba2-780m's and zamba2-2.7b's d_inner halves at a forward's, a train
# step's and a decode step's rows, an odd width, the looped body's width
RMSNORM_SPLIT_SHAPES = [(1000, 1536), (2048, 2560), (4, 2560), (37, 300),
                        (3, 16392)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", RMSNORM_SPLIT_SHAPES)
def test_cuda_rmsnorm_split_matches_plain(shape, dtype):
    """The split-row kernels, forward and backward: on a whole row (no
    group) the whole-row kernels' bits; over a world-1 group at d_total =
    3 D (the other columns' squares summed as 0) against autograd through
    ``ref.rmsnorm_split_ref`` on the same group, at the kernels'
    tolerances; one launch a direction."""
    _need_cuda()
    from repro_torch.launch import mesh as M
    smoke = _smoke()
    tdt, atol, rtol = DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=g, device="cuda").to(tdt)
    s = (1.0 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")
         ).to(tdt)
    gy = torch.randn(shape, generator=g, device="cuda").to(tdt)
    D = shape[-1]
    xk, sk = x.clone().requires_grad_(), s.clone().requires_grad_()
    before = (trn.rmsnorm_split.launches, trn.rmsnorm_split_bwd.launches)
    y = trn.rmsnorm_split(xk, sk, d_total=D)
    y.backward(gy)
    torch.cuda.synchronize()
    assert (trn.rmsnorm_split.launches, trn.rmsnorm_split_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(y, trn.rmsnorm(x, s))
    dx, ds = trn.rmsnorm_bwd(x, s, gy)
    assert torch.equal(xk.grad, dx) and torch.equal(sk.grad, ds)
    M.init_world(device="cuda")
    try:
        group = torch.distributed.group.WORLD
        xk, sk = x.clone().requires_grad_(), s.clone().requires_grad_()
        y = trn.rmsnorm_split(xk, sk, d_total=3 * D, group=group)
        y.backward(gy)
        xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
        want = tref.rmsnorm_split_ref(xr, sr, d_total=3 * D, group=group)
        want.backward(gy)
        torch.cuda.synchronize()
    finally:
        M.shutdown()
    torch.testing.assert_close(y.float(), want.float(), atol=atol,
                               rtol=rtol)
    err, ok, tol = smoke.check_normwise((xk.grad, sk.grad),
                                        (xr.grad, sr.grad), dtype)
    assert ok, (err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,scale_dtype",
                         [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_cuda_rmsnorm_split_takes_mixed_dtypes(x_dtype, scale_dtype):
    """x and scale of different dtypes, as the whole-row kernel takes them:
    the split-row kernels on a whole row give the whole-row kernels' bits,
    forward and backward."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    R, D = 64, 1536
    x, gy = (torch.randn((R, D), generator=g, device="cuda")
             .to(DTYPES[x_dtype][0]) for _ in range(2))
    s = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")
         ).to(DTYPES[scale_dtype][0])
    xk, sk = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = trn.rmsnorm_split(xk, sk, d_total=D)
    y.backward(gy)
    torch.cuda.synchronize()
    assert torch.equal(y, trn.rmsnorm(x, s))
    dx, ds = trn.rmsnorm_bwd(x, s, gy)
    assert torch.equal(xk.grad, dx) and torch.equal(sk.grad, ds)


FLASH_BWD_CASES = [
    (2, 128, 128, 4, 2, 128, True),
    (1, 300, 300, 4, 1, 64, True),
    (1, 100, 260, 2, 2, 32, True),
    (1, 260, 100, 2, 2, 16, True),
    (2, 77, 130, 4, 2, 128, False),
    (1, 129, 1, 4, 2, 128, True),      # one key: dq = dk = 0 (below)
    (1, 129, 2, 4, 2, 128, True),      # two keys, a row past a q tile
    (1, 300, 300, 8, 2, 160, True),
    (2, 200, 200, 4, 4, 256, True),
    (1, 100, 230, 4, 1, 256, False),
    (1, 300, 300, 32, 32, 160, True),  # zamba2-2.7b's shared block
    (1, 300, 300, 16, 16, 256, True),  # gemma-7b
    (1, 200, 333, 4, 4, 160, True),    # D = 160, S < T
    (1, 300, 150, 4, 4, 160, False),   # D = 160, S > T, not causal
    (2, 448, 448, 16, 16, 64, True),   # whisper-medium's train step
    (1, 256, 256, 64, 8, 128, True),   # GQA 8 (llama-3.2-vision's heads)
    *VIT_FLASH_CASES,
    *TF32_FLASH_CASES,
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal", FLASH_BWD_CASES)
def test_cuda_flash_attention_bwd_matches_plain(B, S, T, H, Hkv, D, causal,
                                                dtype):
    """dq, dk, dv through FlashAttentionFn (forward kernel with lse, then
    the backward kernels) against autograd through the plain version, from
    the model's (B,S,H,D) layout."""
    _need_cuda()
    smoke = _smoke()
    tdt = DTYPES[dtype][0]
    g = torch.Generator(device="cuda").manual_seed(2)
    q, do = (torch.randn((B, S, H, D), generator=g, device="cuda").to(tdt)
             for _ in range(2))
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(tdt)
            for _ in range(2))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    tops.flash_attention(*ins, causal=causal).backward(do)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    tref.flash_attention_ref(*refs, scale=D ** -0.5,
                             causal=causal).backward(do)
    got, want = [t.grad for t in ins], [t.grad for t in refs]
    if T == 1:
        # one key: P = 1 on every row, so the plain dq and dk are exactly
        # 0 and a norm-wise check has no scale.  The kernel's dS = dP - Di
        # is a difference of two sums of the same products dO.v, taken in
        # different orders; dq and dk are held against the size of
        # scale * dO.v * k, and dv norm-wise
        assert not want[0].any() and not want[1].any()
        size = (D ** -0.5 * float(do.float().abs().max())
                * float(v.float().abs().max())
                * float(k.float().abs().max()))
        floor = smoke.BWD_TOL[dtype] * size
        for name, gr in (("dq", got[0]), ("dk", got[1])):
            assert torch.isfinite(gr.float()).all(), name
            assert float(gr.float().abs().max()) <= floor, (name, floor)
        got, want = got[2:], want[2:]
    err, ok, tol = smoke.check_normwise(got, want, dtype)
    assert ok, (err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,Hkv", [(8, 4), (8, 8)])
@pytest.mark.parametrize("D", [160, 256])
def test_cuda_flash_attention_wide_head_dims_match_plain(D, H, Hkv, dtype):
    """The forward at the head dims of zamba2's shared block and gemma-7b
    (the tensor-core body in bf16, the FMA body in fp32), with GQA and
    MHA, at a ragged S, with the tolerance of the other widths."""
    _need_cuda()
    tdt, atol, rtol = DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((2, 300, H, D), generator=g, device="cuda").to(tdt)
    k, v = (torch.randn((2, 300, Hkv, D), generator=g, device="cuda").to(tdt)
            for _ in range(2))
    got = tops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = tref.flash_attention_ref(q, k, v, scale=D ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _tiny_ssm():
    """Pure mamba2 with tied embeddings (as mamba2-780m), two B/C groups
    and a chunk of 16, so a 150-token sequence spans 10 chunks, the last
    ragged."""
    from repro_torch.configs.base import ArchConfig, Segment, SSMSpec
    return ArchConfig(name="ssm-tiny", family="ssm", n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                      vocab=300,
                      ssm=SSMSpec(d_state=64, head_dim=32, n_groups=2,
                                  chunk=16),
                      pattern=(Segment(("mamba2",), 2),),
                      tie_embeddings=True, dtype="float32",
                      param_dtype="float32")


def _tiny_shared():
    """zamba2's shape: the weight-shared attention block (2 x 128 wide, 4
    heads of 64) applied twice, each before a mamba2 layer of d_state 64,
    GeGLU, tied embeddings."""
    import dataclasses

    from repro_torch.configs.base import Segment
    return dataclasses.replace(
        _tiny_ssm(), name="shared-tiny", family="hybrid", n_layers=4,
        act="geglu", pattern=(Segment(("shared_attn", "mamba2"), 2),))


@pytest.mark.gpu
@pytest.mark.parametrize("model,impl,remat", [
    ("qwen", "xla", "none"), ("qwen", "pallas", "none"),
    ("qwen", "pallas", "full"), ("qwen", "pallas", "selective"),
    ("ssm", "pallas", "none"), ("ssm", "pallas", "full"),
    ("ssm", "pallas", "selective"), ("shared", "pallas", "none"),
    ("shared", "pallas", "full")],
    ids=["xla-none", "pallas-none", "pallas-full", "pallas-selective",
         "ssm-pallas-none", "ssm-pallas-full", "ssm-pallas-selective",
         "shared-pallas-none", "shared-pallas-full"])
def test_cuda_loss_backward_matches_cpu(model, impl, remat):
    """loss.backward() through lm_apply on the card (RMSNorm kernels; under
    impl="pallas" the flash kernels, forward and backward; for the mamba2
    and shared-block models the SSD scan's kernels, forward and backward,
    whatever impl is; with remat, the forward kernels run again in the
    backward's recompute) gives every param leaf the CPU plain path's
    gradient; every norm ``scale`` leaf gets one, and the shared block's
    params the sum over its applications."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import transformer as T
    from repro_torch.runtime import steps as ST
    arch = {"qwen": _tiny_qwen, "ssm": _tiny_ssm,
            "shared": _tiny_shared}[model]()
    params = T.init_lm(arch, device="cpu", seed=0)
    tokens = torch.randint(0, arch.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(0))
    labels = torch.roll(tokens, -1, dims=1)
    loss_fn = ST.make_loss_fn(arch, impl=impl, remat=remat)
    before = (trn.rmsnorm_bwd.launches, tssd.ssd_scan_bwd.launches,
              tfa.flash_attention_bwd.launches)
    got = ST.loss_and_grads(loss_fn, _to(params, "cuda"), tokens.cuda(),
                            labels.cuda())
    torch.cuda.synchronize()
    # norms a block (qwen's q/k norms too; the shared block's two at 2d),
    # + the final one; SSD and flash backwards, one a mamba2 block and one
    # an attention block (under impl="pallas")
    norms, scans, attns = {"qwen": (4, 0, 2), "ssm": (2, 2, 0),
                           "shared": (2, 2, 2)}[model]
    assert trn.rmsnorm_bwd.launches - before[0] == norms * arch.n_layers + 1
    assert tssd.ssd_scan_bwd.launches - before[1] == scans
    assert tfa.flash_attention_bwd.launches - before[2] == \
        (attns if impl == "pallas" else 0)
    want = ST.loss_and_grads(loss_fn, params, tokens, labels)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-5, rtol=1e-5)
    names = tree.names(params)
    # qwen: norm1, norm2, q_norm, k_norm (each stacked over the layers),
    # final; mamba2: the block's norm, the mixer's gated norm, final; the
    # shared-block model: those of mamba2 and the shared norm1, norm2
    assert sum(n.endswith("scale") for n in names) == \
        {"qwen": 5, "ssm": 3, "shared": 5}[model]
    for n, g, w in zip(names, got[2], want[2]):
        assert g is not None, n
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-4,
                                   msg=n)


@pytest.mark.gpu
def test_cuda_mamba2_mixer_grads_match_cpu():
    """The mamba2 mixer under grad from a carried state and conv buffers,
    with padded rows past new_lens (their dt zeroed by a select), on the
    card (SSD forward and backward kernels: h0 and h_final both carry a
    gradient) against the CPU's plain scan: every param's, x's and the
    carried state's and buffers' grads, fp32."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import mamba2 as M2
    cfg = M2.Mamba2Config(d_model=128, d_state=64, head_dim=32, n_groups=2,
                          chunk=16)
    g = torch.Generator().manual_seed(0)
    p = M2.init_mamba2(cfg, generator=g, device="cpu")
    B, S = 2, 70
    x, gy = (torch.randn((B, S, 128), generator=g) for _ in range(2))
    gh = torch.randn((B, cfg.n_heads, 32, 64), generator=g)
    cache = {k: torch.randn(v.shape, generator=g)
             for k, v in M2.init_mamba2_cache(cfg, B, device="cpu").items()}
    new_lens = torch.tensor([70, 41])

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in tree.leaves(p)]
        xs = x.to(device).requires_grad_()
        cs = {k: v.to(device).requires_grad_() for k, v in cache.items()}
        y, nc = M2.mamba2(tree.unflatten(p, leaves), cfg, xs, cache=cs,
                          new_lens=new_lens.to(device))
        loss = (y * gy.to(device)).sum() + (nc["ssm"] * gh.to(device)).sum()
        ins = leaves + [xs] + [cs[k] for k in sorted(cs)]
        return [t.cpu() for t in torch.autograd.grad(loss, ins)]
    before = tssd.ssd_scan_bwd.launches
    got = grads("cuda")
    torch.cuda.synchronize()
    assert tssd.ssd_scan_bwd.launches == before + 1
    want = grads("cpu")
    for gg, w in zip(got, want):
        assert torch.isfinite(gg).all()
        assert float((gg - w).abs().max()) <= 1e-4 * float(w.abs().max())


def _poison_outputs(monkeypatch):
    """The flash wrappers' outputs start as NaN, so that rows a wrong
    kernel leaves unwritten show (the caching allocator would otherwise
    hand back the right kernel's results of the same size)."""
    like = tfa._like
    monkeypatch.setattr(tfa, "_like",
                        lambda t: like(t).fill_(float("nan")))


def _build_mutants(tmp_path, source: str, mutants: dict) -> dict:
    """Each (old, new) edit of ``csrc/<source>``, compiled in parallel into
    ``tmp_path`` -> {name: loaded library}."""
    src = (tbuild.CSRC / source).read_text()
    procs = {}
    for i, (name, (old, new)) in enumerate(mutants.items()):
        assert src.count(old) == 1, name
        cu, so = tmp_path / f"mutant{i}.cu", tmp_path / f"mutant{i}.so"
        cu.write_text(src.replace(old, new))
        procs[name] = (so, subprocess.Popen(
            tbuild.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        assert p.returncode == 0, f"{name}: {out}"
        libs[name] = tbuild.open_library(so)
    return libs


# Wrong flash kernels, each one edit away from csrc/flash_attention.cu:
# (source text, replacement).  The bf16 tensor-core body's: the classic
# bugs of a flash kernel, the lo term of P dropped (P rounded to bf16 once,
# as the reference's plain attention does in layers._sdpa) and V read as a
# K-major operand.  The fp32 FMA body's (D = 160 and 256): the same classic
# bugs and P rounded to bf16.  The fp32 split-TF32 body's (D <= 128): the
# small terms dropped (one TF32 product), the last 16-row slice dropped,
# the mask one key late, the kv heads interleaved.
FLASH_MUTANTS_BF16 = {
    "mask one key late": ("(causal && key > rows[r])",
                          "(causal && key > rows[r] + 1)"),
    "kv heads interleaved": ("const int kvh = h / group;",
                             "const int kvh = h % (gridDim.x / group);"),
    "acc not rescaled": ("""acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];""", "(void)alpha;"),
    "lo term of P dropped": (
        "wgmma_rs_wide<kTransV>(acc, p_lo[kk], vk, kRest);", ""),
    "V read untransposed": ("constexpr int kTransV = 1;",
                            "constexpr int kTransV = 0;"),
}
FLASH_MUTANTS_FP32 = {
    "mask one key late": ("(!causal || q_pos >= k_pos)",
                          "(!causal || q_pos + 1 >= k_pos)"),
    "kv heads interleaved": ("const int hk = h / group;",
                             "const int hk = h % (gridDim.y / group);"),
    "acc not rescaled": ("acc[i][j] *= alpha;", "(void)alpha;"),
    "probs in bf16": ("Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;",
                      "Ps[(ty * 4 + i) * PP + tx + 16 * j] = "
                      "__bfloat162float(__float2bfloat16(p));"),
}
# the split-TF32 bodies' products (mma_term, in each source): the small
# terms dropped, one TF32 product left
TF32_SMALL_TERMS = ("constexpr int kFirstTerm = 0;",
                    "constexpr int kFirstTerm = 2;")
FLASH_MUTANTS_TF32 = {
    "tf32: small terms dropped": TF32_SMALL_TERMS,
    "tf32: last 16-row slice dropped": ("const bool live = r0 < S;",
                                  "const bool live = r0 + 16 < S;"),
    "tf32: mask one key late": ("(causal && key > row)) x = kNegInf;",
                          "(causal && key > row + 1)) x = kNegInf;"),
    "tf32: kv heads interleaved": ("const int kv_head = h / group;",
                             "const int kv_head = h % (gridDim.y / group);"),
}
# which of a body's mutants a shape can show: not causal, no mask is one
# key late; with as many kv heads as q heads, none are interleaved
def _shows(name: str, causal: bool, H: int, Hkv: int) -> bool:
    if "mask" in name:
        return causal
    if "kv heads" in name:
        return H != Hkv
    return True


@pytest.mark.gpu
def test_smoke_check_rejects_wrong_flash_kernels(tmp_path, monkeypatch):
    """chip_smoke.py's kernel check fails every mutant of the body its
    dtype and head dim run: the bf16 body's in bf16 at the qwen3-8b
    forward's attention and at D = 160 and 256 (zamba2-2.7b's and
    gemma-7b's head dims, with GQA so that a wrong kv head shows, and a
    ragged S); the fp32 FMA body's in fp32 at D = 160 and 256; the fp32
    split-TF32 body's in fp32 at qwen3-8b's (D = 128, causal, GQA 4), at
    ViT-B's (S = 65, D = 64, not causal) and at a causal GQA-4 one at D =
    64, each mutant where the shape can show it.  Outputs start as NaN."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    mutants = {("bfloat16", n): m for n, m in FLASH_MUTANTS_BF16.items()}
    mutants.update({("float32", n): m for n, m in FLASH_MUTANTS_FP32.items()})
    mutants.update({("float32", n): m for n, m in FLASH_MUTANTS_TF32.items()})
    libs = _build_mutants(tmp_path, "flash_attention.cu", mutants)

    g = torch.Generator(device="cuda").manual_seed(0)
    rejected = {}
    # (B, S, H, Hkv, D, causal): the qwen3-8b forward's attention, D = 160
    # and 256, ViT-B's, a causal GQA-4 one at D = 64
    shapes = ((2, 512, 32, 8, 128, True), (2, 500, 8, 4, 160, True),
              (2, 300, 8, 4, 256, True), (2, 65, 12, 12, 64, False),
              (2, 200, 16, 4, 64, True))
    for shape in shapes:
        B, S, H, Hkv, D, causal = shape
        for dn, (tdt, _, _) in DTYPES.items():
            q = torch.randn((B, S, H, D), generator=g, device="cuda").to(tdt)
            k = torch.randn((B, S, Hkv, D), generator=g,
                            device="cuda").to(tdt)
            v = torch.randn((B, S, Hkv, D), generator=g,
                            device="cuda").to(tdt)
            want = tref.flash_attention_ref(q, k, v, scale=D ** -0.5,
                                            causal=causal)
            for name, lib in [(("kernel", "kernel"), None), *libs.items()]:
                if name[0] not in ("kernel", dn):
                    continue
                _poison_outputs(monkeypatch)
                if lib is not None:
                    monkeypatch.setattr(tfa, "_fn", tfa.bind(lib))
                got = tops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err, ok, tol = smoke.check_close(got, want, dn)
                print(f"flash {name[1]} {dn} {shape}: max_abs_err {err:.3g} "
                      f"({'passes' if ok else 'fails'} {tol})")
                rejected[name[1], dn, shape] = not ok
                monkeypatch.undo()
    for shape in shapes:
        B, S, H, Hkv, D, causal = shape
        assert not rejected["kernel", "float32", shape]
        assert not rejected["kernel", "bfloat16", shape]
        if D >= 128:
            for name in FLASH_MUTANTS_BF16:
                assert rejected[name, "bfloat16", shape], (name, shape)
        wrong = (FLASH_MUTANTS_FP32 if D not in tfa.TF32_DIMS
                 else FLASH_MUTANTS_TF32)
        for name in wrong:
            if _shows(name, causal, H, Hkv):
                assert rejected[name, "float32", shape], (name, shape)


# Wrong RMSNorm kernels, each one edit away from csrc/rmsnorm.cu
RMSNORM_MUTANTS = {
    "squares of half the vectors": (
        "if (i < nv && vi < nvec && active)",
        "if (2 * i < nv && vi < nvec && active)"),
    "scale at the wrong lane offset": (
        "sbuf[i] = sr[vi];", "sbuf[i] = sr[(vi + 1) % nvec];"),
}
# and of its looped body (rows past the register-held widths)
RMSNORM_LOOP_MUTANTS = {
    "looped: squares of half the vectors": (
        "ss += f * f;", "ss += (vi & 1) ? 0.f : f * f;"),
    "looped: scale at the wrong offset": (
        "const VS sv = sr[vi];\n    V out;",
        "const VS sv = sr[(vi + 1) % nvec];\n    V out;"),
}


# Wrong backward kernels, each one edit away from its source.  The bf16
# tensor-core body's (csrc/flash_attention_bwd.cu): the mask dropped in the
# dK/dV kernel, dK/dV from the items of one q head of the group, Di left
# out of the pre-pass, lse taken in natural-log units where the kernels
# want log2, and the peer block's half of the items (cluster rank 1)
# dropped from the sum.  The fp32 FMA body's (D = 160 and 256): the mask
# dropped, dK/dV summed over one q head, Di left out of dS.  The fp32
# split-TF32 body's (D <= 128): the small terms dropped (one TF32
# product), the last 16-key slice dropped, Di left out, the mask one key
# late, the kv heads interleaved.  RMSNorm: dscale from one partial row.
FLASH_BWD_MUTANTS_BF16 = {
    "mask dropped": ("if (diag && kr[r] > q0 + c) p = 0.f;", "(void)diag;"),
    "dK/dV from one q head": ("const int items = group * per_head;",
                              "const int items = per_head;"),
    "Di left out": ("di[row] = in ? acc : 0.f;", "di[row] = 0.f;"),
    "lse in natural log": (
        "lse2[row] = in ? lse[bh * S + s] * kLog2e : kPadLse;",
        "lse2[row] = in ? lse[bh * S + s] : kPadLse;"),
    "peer block's items dropped": ("""        dv_acc[i] += peer[i * 128 + wt];
        dk_acc[i] += peer[(D / 2 + i) * 128 + wt];""", "(void)peer;"),
}
# the mutants above that edit code the D = 160 body does not run
FLASH_BWD_MUTANTS_BF16_NARROW = ("peer block's items dropped",)
# and of the D = 160 body's dK/dV split by product: warpgroup 1 reading
# P^T from another thread's slot, the peer block's sums dropped
FLASH_BWD_MUTANTS_BF16_WIDE = {
    "P^T read from another thread's slot": (
        "sc[x] = xch[x * 128 + wt] *", "sc[x] = xch[x * 128 + (wt ^ 4)] *"),
    "peer block's sums dropped (D = 160)": (
        "acc[i] += peer[(wg * D / 2 + i) * 128 + wt];", "(void)peer;"),
}
FLASH_BWD_MUTANTS = {
    "mask dropped": (
        "return q_pos < S && k_pos < Tk && (!causal || q_pos >= k_pos);",
        "return true;"),
    "dK/dV from one q head": ("for (int h = h0; h < h0 + group; ++h) {",
                              "for (int h = h0; h < h0 + 1; ++h) {"),
    "Di left out": ("return p * (dp - di);", "return p * dp;"),
}
FLASH_BWD_MUTANTS_TF32 = {
    "tf32: small terms dropped": TF32_SMALL_TERMS,
    "tf32: last 16-key slice dropped": ("const bool live = kw < Tk;",
                                  "const bool live = kw + 16 < Tk;"),
    "tf32: Di left out": ("di_s[r] = in ? acc : 0.f;", "di_s[r] = 0.f;"),
    "tf32: mask one key late": (
        "const bool keep = row < S && key < Tk && (!causal || key <= row);",
        "const bool keep = row < S && key < Tk && "
        "(!causal || key <= row + 1);"),
    "tf32: kv heads interleaved": ("const int h = hk * group + j;",
                             "const int h = j * Hkv + hk;"),
}
# Wrong SSD backward kernels, each one edit away from csrc/
# ssd_scan_bwd.cu.  The fp32 FMA body's: the decay not selected above the
# diagonal, formed as exp(cum_i)·exp(-cum_j), da without its reverse
# cumsum, dB and dC from one head of each group, the state gradient not
# carried across chunks.  The bf16 tensor-core body's: the mask as a
# multiply (inf * 0 above the diagonal), dy's lo term dropped from dS (dy
# rounded to bf16 once there), one head slice's dB / dC partial left out
# of the sum, the state gradient not carried, da without its reverse
# cumsum.
SSD_BWD_MUTANTS = {
    "mask dropped": ("const bool keep = j <= i && i < q;",
                     "const bool keep = i < q;"),
    "exp(cum_i) exp(-cum_j)": (
        "const float l = keep ? expf(cum[i] - cum[j]) : 0.f;",
        "const float l = keep ? expf(cum[i]) * expf(-cum[j]) : 0.f;"),
    "da without the reverse cumsum": ("      vdcum[k] = run;",
                                      "      (void)run;"),
    "dB, dC from one head": ("for (int k = 0; k < hpg; ++k) {",
                             "for (int k = 0; k < 1; ++k) {"),
    "dh not carried": ("dh = decay(e[k], dh, v[k]);", "dh = v[k];"),
}
SSD_BWD_MUTANTS_BF16 = {
    "mask as a multiply": (
        "const float lv = in ? expf(cum[i] - cj[r]) : 0.f;   // select",
        "const float lv = expf(cum[i] - cj[r]) * (float)in;"),
    "lo term of dy dropped": ("wgmma_ss<64>(ds, a, dylK + o, 1);", ""),
    "one head slice's partial dropped": (
        "for (int k = 0; k < p.nsl; ++k) {",
        "for (int k = 1; k < p.nsl; ++k) {"),
    "dh not carried": ("dh = decay(e[k], dh, v[k]);", "dh = v[k];"),
    "da without the reverse cumsum": ("rv[k] = run;", "(void)run;"),
}
RMSNORM_BWD_MUTANTS = {
    "dscale from one partial": (
        "for (int b = w; b < blocks; b += kDscaleWarps)",
        "for (int b = w; b < 1; b += kDscaleWarps)"),
}
# the split-row modes' (csrc/rmsnorm.cu's kSumSq and kApply):
# the forward normalising by this rank's width, not the row's; the sums
# pass writing half of sum(x^2); the backward's sum(g*s*x) dropped; the
# backward normalising by this rank's width
RMSNORM_SPLIT_MUTANTS = {
    "split: forward over the local width": (
        "rsqrtf(sums[active ? row : 0] / static_cast<float>(d_total) + eps)",
        "rsqrtf(sums[active ? row : 0] / static_cast<float>(d) + eps)"),
    "split: half the squares": ("if (active && lane == 0) sums[row] = ss;",
                                "if (active && lane == 0) sums[row] = 0.5f * ss;"),
    "split: backward without sum(g*s*x)": ("sums[2 * row + 1] = gsx;",
                                           "sums[2 * row + 1] = 0.f;"),
    "split: backward over the local width": (
        "dn = static_cast<float>(d_total);", "dn = static_cast<float>(d);"),
}
# the looped backward's: its rows' g * xh left out of dscale
RMSNORM_BWD_LOOP_MUTANTS = {
    "looped: g * xh never added to the partial row": (
        "add_to(prow + vi * VEC, gxh);", "(void)gxh;"),
}


@pytest.mark.gpu
def test_smoke_check_rejects_wrong_rmsnorm_kernels(tmp_path, monkeypatch):
    """chip_smoke.py's kernel check fails every RMSNorm mutant in both
    dtypes: the register-held body's at the qwen3-8b forward's (1024, 4096)
    rows and at command-r-plus-104b's (1024, 12288), the looped body's at
    (256, 12289)."""
    _need_cuda()
    smoke = _smoke()
    mutants = dict(RMSNORM_MUTANTS, **RMSNORM_LOOP_MUTANTS)
    libs = _build_mutants(tmp_path, "rmsnorm.cu", mutants)
    g = torch.Generator(device="cuda").manual_seed(0)
    rejected = {}
    cases = {(1024, 4096): RMSNORM_MUTANTS, (1024, 12288): RMSNORM_MUTANTS,
             (256, 12289): RMSNORM_LOOP_MUTANTS}
    for (R, D), wrong in cases.items():
        for dn, (tdt, _, _) in DTYPES.items():
            x = torch.randn((R, D), generator=g, device="cuda").to(tdt)
            s = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")
                 ).to(tdt)
            want = tref.rmsnorm_ref(x, s)
            for name, lib in [("kernel", None), *libs.items()]:
                if lib is not None:
                    if name not in wrong:
                        continue
                    monkeypatch.setattr(trn, "_fn", trn.bind(lib))
                got = trn.rmsnorm(x, s)
                torch.cuda.synchronize()
                err, ok, tol = smoke.check_close(got, want, dn)
                print(f"rmsnorm {name} {dn} ({R}, {D}): max_abs_err "
                      f"{err:.3g} ({'passes' if ok else 'fails'} {tol})")
                rejected[name, dn, D] = not ok
            monkeypatch.undo()
    for (R, D), wrong in cases.items():
        assert not rejected["kernel", "float32", D]
        assert not rejected["kernel", "bfloat16", D]
        for name in wrong:
            assert rejected[name, "float32", D], (name, D)
            assert rejected[name, "bfloat16", D], (name, D)


@pytest.mark.gpu
def test_smoke_check_rejects_wrong_split_rmsnorm_kernels(tmp_path,
                                                         monkeypatch):
    """chip_smoke.py's split-row rows (``split_norm_rows``: d_total = 2 D,
    the forward by ``check_close``, the backward by ``check_normwise``)
    fail every split-mode mutant in both dtypes at zamba2-2.7b's train
    shape (2048, 2560) and pass the kernel."""
    _need_cuda()
    smoke = _smoke()
    libs = _build_mutants(tmp_path, "rmsnorm.cu", RMSNORM_SPLIT_MUTANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    R, D = 2048, 2560
    for dn, (tdt, _, _) in DTYPES.items():
        x, gy = (torch.randn((R, D), generator=g, device="cuda").to(tdt)
                 for _ in range(2))
        s = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(tdt)
        xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
        want = tref.rmsnorm_split_ref(xr, sr, d_total=2 * D)
        want_g = torch.autograd.grad(want, (xr, sr), gy)
        for name, lib in [("kernel", None), *libs.items()]:
            if lib is not None:
                monkeypatch.setattr(trn, "_split_fn", trn.bind_split(lib))
                monkeypatch.setattr(trn, "_split_bwd_fn",
                                    trn.bind_split_bwd(lib))
            y = trn._split_forward(x, s, 1e-6, 2 * D, None)
            grads = trn._split_backward(x, s, gy, 1e-6, 2 * D, None)
            torch.cuda.synchronize()
            ok = (smoke.check_close(y, want.detach(), dn)[1]
                  and smoke.check_normwise(grads, want_g, dn)[1])
            print(f"rmsnorm_split {name} {dn}: "
                  f"{'passes' if ok else 'fails'}")
            assert ok == (lib is None), (name, dn)
            monkeypatch.undo()


def _ssd_case(smoke, B, S, H, P, N, G, dtype, has_h0, dt_bias=None, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dt_bias is None:       # the init's: inverse softplus of [1e-3, 0.1]
        u = torch.rand((H,), generator=g, device="cuda")
        dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return smoke.ssd_inputs(torch, g, B, S, H, P, N, G, dt_bias, dtype,
                            has_h0)


# (B, S, H, P, N, G, chunk, h0): the served prefill chunk and forward of
# mamba2-780m, then ragged S, Q < chunk, two groups, a small chunk, a
# head_dim narrower than the fp32 kernel's 16-row tile with three groups,
# widths whose rows are no 16-byte multiple (P = 12, N = 24: the bf16
# kernel loads its tiles itself instead of by TMA), and zamba2-2.7b's
# served prefill chunk and forward (80 heads, d_state 64)
SSD_CASES = [
    (1, 256, 48, 64, 128, 1, 128, True),
    (2, 500, 48, 64, 128, 1, 128, False),
    (1, 300, 8, 64, 128, 1, 128, False),
    (1, 100, 8, 64, 128, 1, 128, False),
    (1, 256, 8, 64, 128, 2, 128, True),
    (2, 33, 4, 32, 64, 1, 16, True),
    (1, 7, 6, 8, 16, 3, 4, True),
    (2, 150, 6, 12, 24, 2, 64, True),
    (1, 256, 80, 64, 64, 1, 128, True),    # zamba2-2.7b: d_state 64
    (2, 500, 80, 64, 64, 1, 128, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,h0", SSD_CASES)
def test_cuda_ssd_scan_matches_plain(B, S, H, P, N, G, chunk, h0, dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    x, Bm, Cm, dt, a, h = _ssd_case(smoke, B, S, H, P, N, G,
                                    DTYPES[dtype][0], h0)
    before = tssd.ssd_scan.launches
    got = tops.ssd_scan(x, Bm, Cm, dt, a, h, chunk=chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_scan.launches == before + 1
    assert got[0].shape == (B, S, H, P) and got[1].shape == (B, H, P, N)
    want = tref.ssd_scan_ref(x, Bm, Cm, dt, a, h, chunk=chunk)
    err, ok, tol = smoke.check_ssd(got, want)
    assert ok, (err, tol)


# (B, S, H, P, N, G, chunk, h0, dh_final): chip_smoke.py's ssd_scan_bwd
# rows (the train step's scan of mamba2-780m, no h0 and no h_final
# gradient; ragged S = 1000 with h0 and h_final gradients; two groups;
# S < Q), then the small and odd widths of SSD_CASES, and zamba2-2.7b's
# train step's scan and a ragged S with h0 and h_final gradients at its
# d_state of 64 (the states' rows loaded by every thread, not by bulk
# copies)
SSD_BWD_CASES = [
    (2, 1024, 48, 64, 128, 1, 128, False, False),
    (1, 1000, 48, 64, 128, 1, 128, True, True),
    (1, 256, 48, 64, 128, 2, 128, True, False),
    (1, 100, 48, 64, 128, 1, 128, False, True),
    (2, 33, 4, 32, 64, 1, 16, True, False),
    (1, 7, 6, 8, 16, 3, 4, True, True),
    (2, 150, 6, 12, 24, 2, 64, True, True),
    (2, 1024, 80, 64, 64, 1, 128, False, False),   # zamba2-2.7b: N = 64
    (1, 300, 80, 64, 64, 1, 128, True, True),
]
# head dims past one 64-column tile, which the bf16 body takes in blocks
# of 64: two full blocks, a ragged second block with three groups, and a
# ragged one with N = 24 (loaded by every thread, not by TMA)
SSD_BWD_WIDE_CASES = [
    (1, 200, 4, 128, 128, 2, 128, True, True),
    (2, 130, 6, 96, 64, 3, 64, True, False),
    (1, 77, 4, 72, 24, 1, 32, False, True),
]


def _ssd_grads(scan, x, Bm, Cm, dt, a, h0, dy, dh, chunk):
    """Autograd of sum(y·dy) (+ sum(h_final·dh)) through ``scan`` -> the
    grads of (x, Bm, Cm, dt, a[, h0])."""
    ins = [t.clone().requires_grad_() for t in (x, Bm, Cm, dt, a)]
    if h0 is not None:
        ins.append(h0.clone().requires_grad_())
    y, hf = scan(*ins[:5], ins[5] if h0 is not None else None, chunk=chunk)
    if dh is None:
        return torch.autograd.grad(y, ins, dy)
    return torch.autograd.grad((y, hf), ins, (dy, dh))


def _ssd_bwd_case(smoke, B, S, H, P, N, G, dtype, h0, dhf, seed=0):
    x, Bm, Cm, dt, a, h = _ssd_case(smoke, B, S, H, P, N, G, dtype, h0,
                                    seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn((B, S, H, P), generator=g, device="cuda")
    dh = (torch.randn((B, H, P, N), generator=g, device="cuda") if dhf
          else None)
    return x, Bm, Cm, dt, a, h, dy, dh


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,h0,dhf",
                         SSD_BWD_CASES + SSD_BWD_WIDE_CASES)
def test_cuda_ssd_scan_bwd_matches_plain(B, S, H, P, N, G, chunk, h0, dhf,
                                         dtype):
    """ssd_scan under grad on the card (forward kernels, then the backward
    kernel, once each) against autograd through the plain scan: every
    gradient norm-wise at chip_smoke.py's BWD_TOL, finite, and in bf16 the
    fp32 gradients (ddt, da, dh0) at its SSD_BWD_F32_TOL
    (``check_ssd_bwd``)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    case = _ssd_bwd_case(smoke, B, S, H, P, N, G, DTYPES[dtype][0], h0, dhf)
    before = tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches
    got = _ssd_grads(tops.ssd_scan, *case, chunk)
    torch.cuda.synchronize()
    assert (tssd.ssd_scan.launches, tssd.ssd_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _ssd_grads(tref.ssd_scan_ref, *case, chunk)
    assert len(got) == len(want) == (6 if h0 else 5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    err, ok, tol = smoke.check_ssd_bwd(got, want, dtype)
    assert ok, (err, tol)


# Wrong SSD kernels, each one edit away from csrc/ssd_scan.cu.  The bf16
# tensor-core body's: the mask as a multiply (inf * 0 above the diagonal),
# the state not passed across chunks, the wrong group, the lo term of w
# (chunk states) or of the scores (y) dropped, and y's inter-chunk term
# read from the wrong chunk's state.  The fp32 FMA body's: the first three.
SSD_MUTANTS_BF16 = {
    "mask by multiply": (
        "v = keep ? v * expf(ci[r] - cum[key]) * dtv[key] : 0.f;",
        "v = v * expf(ci[r] - cum[key]) * dtv[key] * (float)keep;"),
    "state not passed across chunks": (
        "h = expf(p.cl[bh * p.nc + c]) * h + s;", "(void)s;"),
    "wrong group index": ("return h / (H / G);", "return h % G;"),
    "lo term of w dropped": (
        "wgmma_ss<64, 1, 1>(acc, ld + off, bd + off, 1);", ""),
    "lo term of the scores dropped": (
        "wgmma_rs<1>(yi, s_lo[kk], xd + off);", ""),
    "state from the wrong chunk": (
        "p.st + (static_cast<size_t>(z) - 1) * pn",
        "p.st + static_cast<size_t>(z) * pn"),
}
SSD_MUTANTS_FP32 = {
    "mask by multiply": (
        "keep ? acc[ii][k] * expf(cum[i] - cum[j]) * dtv[j] : 0.f",
        "acc[ii][k] * expf(cum[i] - cum[j]) * dtv[j] * (float)keep"),
    "state not carried across chunks": (
        "Hs[(r0 + m) * ldh + n] = dlast * Hs[(r0 + m) * ldh + n] + acc[m];",
        "(void)dlast;"),
    "wrong group index": ("const int g = h / group;",
                          "const int g = h % (H / group);"),
}


@pytest.mark.parametrize("source,mutants", [
    ("flash_attention.cu", FLASH_MUTANTS_BF16),
    ("flash_attention.cu", FLASH_MUTANTS_FP32),
    ("rmsnorm.cu", RMSNORM_MUTANTS),
    ("ssd_scan.cu", SSD_MUTANTS_FP32),
    ("ssd_scan.cu", SSD_MUTANTS_BF16),
    ("flash_attention_bwd.cu", FLASH_BWD_MUTANTS),
    ("rmsnorm.cu", RMSNORM_BWD_MUTANTS),
    ("flash_attention_bwd.cu", FLASH_BWD_MUTANTS_BF16),
    ("ssd_scan_bwd.cu", SSD_BWD_MUTANTS),
    ("ssd_scan_bwd.cu", SSD_BWD_MUTANTS_BF16),
    ("rmsnorm.cu", RMSNORM_LOOP_MUTANTS),
    ("rmsnorm.cu", RMSNORM_BWD_LOOP_MUTANTS),
    ("flash_attention_bwd.cu", FLASH_BWD_MUTANTS_BF16_WIDE),
    ("flash_attention.cu", FLASH_MUTANTS_TF32),
    ("flash_attention_bwd.cu", FLASH_BWD_MUTANTS_TF32),
    ("rmsnorm.cu", RMSNORM_SPLIT_MUTANTS),
], ids=["flash-bf16", "flash-fp32", "rmsnorm", "ssd", "ssd-bf16",
        "flash-bwd", "rmsnorm-bwd", "flash-bwd-bf16", "ssd-bwd",
        "ssd-bwd-bf16", "rmsnorm-loop", "rmsnorm-bwd-loop",
        "flash-bwd-bf16-wide", "flash-tf32", "flash-bwd-tf32",
        "rmsnorm-split"])
def test_every_mutant_edit_applies_once(source, mutants):
    """Each wrong kernel above is one edit of text that occurs exactly once
    in its source, so the card's mutant tests build what they claim.  Runs
    without a card."""
    src = (tbuild.CSRC / source).read_text()
    for name, (old, new) in mutants.items():
        assert src.count(old) == 1, name
        assert src.replace(old, new) != src, name


@pytest.mark.gpu
def test_smoke_check_rejects_wrong_ssd_kernels(tmp_path, monkeypatch):
    """chip_smoke.py's SSD check fails every mutant of the body its dtype
    runs (the bf16 body's in bf16, the fp32 body's in fp32), at
    mamba2-780m's widths with two groups, three chunks (S = 300) and h0 !=
    0.  dt = softplus(N(0, 1)), as tests/test_kernels.py draws it, so
    exp(cum_i - cum_j) overflows above the diagonal within a few rows."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    mutants = {("bfloat16", n): m for n, m in SSD_MUTANTS_BF16.items()}
    mutants.update({("float32", n): m for n, m in SSD_MUTANTS_FP32.items()})
    libs = _build_mutants(tmp_path, "ssd_scan.cu", mutants)
    rejected = {}
    for dn, (tdt, _, _) in DTYPES.items():
        x, Bm, Cm, dt, a, h0 = _ssd_case(
            smoke, 1, 300, 48, 64, 128, 2, tdt, True,
            dt_bias=torch.zeros(48, device="cuda"))
        want = tref.ssd_scan_ref(x, Bm, Cm, dt, a, h0)
        for name, lib in [(("kernel", "kernel"), None), *libs.items()]:
            if name[0] not in ("kernel", dn):
                continue
            if lib is not None:
                monkeypatch.setattr(tssd, "_fn", tssd.bind(lib))
            got = tops.ssd_scan(x, Bm, Cm, dt, a, h0)
            torch.cuda.synchronize()
            err, ok, tol = smoke.check_ssd(got, want)
            print(f"ssd {name[1]} {dn}: max_abs_err {err:.3g} "
                  f"({'passes' if ok else 'fails'} {tol})")
            rejected[name[1], dn] = not ok
        monkeypatch.undo()
    assert not rejected["kernel", "float32"]
    assert not rejected["kernel", "bfloat16"]
    for name in SSD_MUTANTS_BF16:
        assert rejected[name, "bfloat16"], name
    for name in SSD_MUTANTS_FP32:
        assert rejected[name, "float32"], name


@pytest.mark.gpu
def test_smoke_check_rejects_wrong_backward_kernels(tmp_path, monkeypatch):
    """chip_smoke.py's backward check fails every wrong backward kernel of
    the body its dtype and head dim run (the flash and SSD tensor-core
    bodies' in bf16; in fp32 the flash split-TF32 body's at D <= 128, its
    FMA body's at D = 160, the SSD FMA body's; RMSNorm's in both), at the
    train steps' shapes: qwen3-8b's attention (B=2, S=512, 32 q heads in
    groups of 4; the TF32 body's key tiles and dQ kernel) and its (1024,
    4096) norm rows, and mamba2-780m's scan (B=2, S=1024, 48 heads in one
    group, 8 chunks of 128; held by ``check_ssd_bwd``); at D = 160 (B=2,
    S=512, 8 q heads in groups of 2, so that a wrong head shows),
    command-r-plus-104b's (1024, 12288) norm rows and the looped body's
    (256, 12289); and for the TF32 body's one block a head, at ViT-B's
    (S = 65, D = 64, not causal) and a causal GQA-4 one at D = 64, each
    mutant where the shape can show it.  Flash outputs start as NaN."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    fmut = {("bfloat16", n): m for n, m in FLASH_BWD_MUTANTS_BF16.items()}
    fmut.update({("bfloat16", n): m
                 for n, m in FLASH_BWD_MUTANTS_BF16_WIDE.items()})
    fmut.update({("float32", n): m for n, m in FLASH_BWD_MUTANTS.items()})
    fmut.update({("float32", n): m
                 for n, m in FLASH_BWD_MUTANTS_TF32.items()})
    flibs = _build_mutants(tmp_path, "flash_attention_bwd.cu", fmut)
    (tmp_path / "r").mkdir()
    rlibs = _build_mutants(tmp_path / "r", "rmsnorm.cu",
                           dict(RMSNORM_BWD_MUTANTS,
                                **RMSNORM_BWD_LOOP_MUTANTS))
    (tmp_path / "s").mkdir()
    smut = {("bfloat16", n): m for n, m in SSD_BWD_MUTANTS_BF16.items()}
    smut.update({("float32", n): m for n, m in SSD_BWD_MUTANTS.items()})
    slibs = _build_mutants(tmp_path / "s", "ssd_scan_bwd.cu", smut)
    g = torch.Generator(device="cuda").manual_seed(4)
    rejected = {}
    # which mutants each shape must reject, beyond those of the body's
    # dtype: the D = 160 body runs neither the D <= 128 reduction nor the
    # other way round
    # (B, S, H, Hkv, D, causal): the bf16 mutants each shape must reject
    flash_shapes = {
        (2, 512, 32, 8, 128, True): set(FLASH_BWD_MUTANTS_BF16),
        (2, 512, 8, 4, 160, True): (set(FLASH_BWD_MUTANTS_BF16)
                                    - set(FLASH_BWD_MUTANTS_BF16_NARROW)
                                    | set(FLASH_BWD_MUTANTS_BF16_WIDE)),
        (2, 65, 12, 12, 64, False): set(),
        (2, 100, 16, 4, 64, True): set()}
    norm_shapes = {(1024, 4096): set(RMSNORM_BWD_MUTANTS),
                   (1024, 12288): set(RMSNORM_BWD_MUTANTS),
                   (256, 12289): set(RMSNORM_BWD_MUTANTS)
                   | set(RMSNORM_BWD_LOOP_MUTANTS)}
    for dn, (tdt, _, _) in DTYPES.items():
        for shape in flash_shapes:
            B, S, H, Hkv, D, causal = shape
            q, do = (torch.randn((B, S, H, D), generator=g,
                                 device="cuda").to(tdt) for _ in range(2))
            k, v = (torch.randn((B, S, Hkv, D), generator=g,
                                device="cuda").to(tdt) for _ in range(2))
            refs = [t.clone().requires_grad_() for t in (q, k, v)]
            tref.flash_attention_ref(*refs, scale=D ** -0.5,
                                     causal=causal).backward(do)
            for name, lib in [(("kernel", "kernel"), None), *flibs.items()]:
                if name[0] not in ("kernel", dn):
                    continue
                _poison_outputs(monkeypatch)
                if lib is not None:
                    monkeypatch.setattr(tfa, "_bwd_fn", tfa.bind_bwd(lib))
                ins = [t.clone().requires_grad_() for t in (q, k, v)]
                tops.flash_attention(*ins, causal=causal).backward(do)
                torch.cuda.synchronize()
                err, ok, tol = smoke.check_normwise(
                    [t.grad for t in ins], [t.grad for t in refs], dn)
                print(f"flash_bwd {name[1]} {dn} {shape}: max_abs_err "
                      f"{err:.3g} ({'passes' if ok else 'fails'} {tol})")
                rejected["flash " + name[1], dn, shape] = not ok
                monkeypatch.undo()
        for (R, D) in norm_shapes:
            x, gy = (torch.randn((R, D), generator=g, device="cuda").to(tdt)
                     for _ in range(2))
            s = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")
                 ).to(tdt)
            xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
            want = torch.autograd.grad(tref.rmsnorm_ref(xr, sr), (xr, sr), gy)
            for name, lib in [("kernel", None), *rlibs.items()]:
                if lib is not None:
                    monkeypatch.setattr(trn, "_bwd_fn", trn.bind_bwd(lib))
                got = trn.rmsnorm_bwd(x, s, gy)
                torch.cuda.synchronize()
                err, ok, tol = smoke.check_normwise(got, want, dn)
                print(f"rmsnorm_bwd {name} {dn} ({R}, {D}): max_abs_err "
                      f"{err:.3g} ({'passes' if ok else 'fails'} {tol})")
                rejected["rmsnorm " + name, dn, D] = not ok
            monkeypatch.undo()
        case = _ssd_bwd_case(smoke, 2, 1024, 48, 64, 128, 1, tdt, False,
                             False, seed=6)
        want = _ssd_grads(tref.ssd_scan_ref, *case, 128)
        for name, lib in [(("kernel", "kernel"), None), *slibs.items()]:
            if name[0] not in ("kernel", dn):
                continue
            if lib is not None:
                monkeypatch.setattr(tssd, "_bwd_fn", tssd.bind_bwd(lib))
            got = _ssd_grads(tops.ssd_scan, *case, 128)
            torch.cuda.synchronize()
            err, ok, tol = smoke.check_ssd_bwd(got, want, dn)
            print(f"ssd_scan_bwd {name[1]} {dn}: max_abs_err {err:.3g} "
                  f"({'passes' if ok else 'fails'} {tol})")
            rejected["ssd " + name[1], dn] = not ok
        monkeypatch.undo()
    for dn in DTYPES:
        assert not rejected["ssd kernel", dn]
        for (R, D), names in norm_shapes.items():
            assert not rejected["rmsnorm kernel", dn, D]
            for name in names:
                assert rejected["rmsnorm " + name, dn, D], (name, D)
        for shape in flash_shapes:
            B, S, H, Hkv, D, causal = shape
            assert not rejected["flash kernel", dn, shape]
            wrong = (FLASH_BWD_MUTANTS if D not in tfa.TF32_DIMS
                     else FLASH_BWD_MUTANTS_TF32)
            for name in wrong:
                if dn == "float32" and _shows(name, causal, H, Hkv):
                    assert rejected["flash " + name, dn, shape], (name,
                                                                  shape)
    for name in SSD_BWD_MUTANTS_BF16:
        assert rejected["ssd " + name, "bfloat16"], name
    for name in SSD_BWD_MUTANTS:
        assert rejected["ssd " + name, "float32"], name
    for shape, names in flash_shapes.items():
        for name in names:
            assert rejected["flash " + name, "bfloat16", shape], (name,
                                                                  shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_backward_kernels_are_deterministic(dtype):
    """No float atomics: two calls of each backward at the train steps'
    shapes (qwen3-8b's attention, B=2 S=512; ViT-B's, S = 65, and
    ViT-B/16's, S = 197, not causal, where fp32 takes the one-block-a-head
    design at five and at 13 warps; its (1024, 4096) norm rows;
    mamba2-780m's scan, B=2 S=1024, with h0 and h_final gradients) give
    the same bits."""
    _need_cuda()
    tdt = DTYPES[dtype][0]
    g = torch.Generator(device="cuda").manual_seed(5)
    first, second = [], []
    for B, S, H, Hkv, D, causal in ((2, 512, 32, 8, 128, True),
                                    (16, 65, 12, 12, 64, False),
                                    (4, 197, 12, 12, 64, False)):
        q, do = (torch.randn((B, H, S, D), generator=g,
                             device="cuda").to(tdt) for _ in range(2))
        k, v = (torch.randn((B, Hkv, S, D), generator=g,
                            device="cuda").to(tdt) for _ in range(2))
        o, lse = tfa._forward(q, k, v, D ** -0.5, causal, with_lse=True)
        for out in (first, second):
            out += tfa.flash_attention_bwd(q, k, v, o, lse, do,
                                           scale=D ** -0.5, causal=causal)
    x, gy = (torch.randn((1024, 4096), generator=g, device="cuda").to(tdt)
             for _ in range(2))
    s = (1.0 + 0.1 * torch.randn(4096, generator=g, device="cuda")).to(tdt)
    first += trn.rmsnorm_bwd(x, s, gy)
    second += trn.rmsnorm_bwd(x, s, gy)
    case = _ssd_bwd_case(_smoke(), 2, 1024, 48, 64, 128, 1, tdt, True, True,
                         seed=7)
    first += tssd.ssd_scan_bwd(*case, chunk=128)
    second += tssd.ssd_scan_bwd(*case, chunk=128)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "vit dq", "vit dk", "vit dv", "vit16 dq",
             "vit16 dk", "vit16 dv", "dx", "dscale", "ssd dx", "ssd dB",
             "ssd dC", "ssd ddt", "ssd da", "ssd dh0")
    assert len(first) == len(second) == len(names)
    for name, a, b in zip(names, first, second):
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_cuda()
    x = torch.randn((4, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        trn.rmsnorm(x, torch.ones(64, device="cuda"))
    xt = torch.randn((64, 4), device="cuda").t()
    with pytest.raises(ValueError, match="contiguous"):
        trn.rmsnorm(xt, torch.ones(64, device="cuda"))
    q = torch.randn((1, 4, 8, 48), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = torch.randn((1 + 8 * 4 * 64,), device="cuda").to(torch.bfloat16)
    q = q[1:].view(1, 4, 8, 64)               # rows 2 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(q, q, q)
    q = torch.randn((1 + 8 * 4 * 64,), device="cuda")
    q = q[1:].view(1, 4, 8, 64)               # fp32 rows 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(q, q, q)
    qa = torch.randn((1, 4, 8, 64), device="cuda")
    o, lse = tfa._forward(qa, qa, qa, 0.125, True, with_lse=True)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_bwd(q, q, q, o, lse, qa, scale=0.125,
                                causal=True)

    def ssd(B=1, S=8, H=4, P=16, N=32, G=1, dtype=torch.bfloat16,
            dt_dtype=torch.float32, chunk=128, h0=None):
        x = torch.randn((B, S, H, P), device="cuda").to(dtype)
        bm = torch.randn((B, S, G, N), device="cuda").to(dtype)
        dt = torch.rand((B, S, H), device="cuda").to(dt_dtype)
        return tops.ssd_scan(x, bm, bm, dt, -dt, h0, chunk=chunk)
    with pytest.raises(ValueError, match="dtypes"):
        ssd(dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        ssd(dt_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d_state"):
        ssd(N=256)
    with pytest.raises(ValueError, match="chunk of 200 rows"):
        ssd(S=200, chunk=256)
    with pytest.raises(ValueError, match="multiple"):
        ssd(H=6, G=4)
    with pytest.raises(ValueError, match="h0"):
        ssd(h0=torch.zeros((1, 4, 16, 16), device="cuda"))
    xt = torch.randn((1, 8, 16, 4), device="cuda").transpose(2, 3)
    d = torch.rand((1, 8, 4), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tops.ssd_scan(xt, xt[:, :, :1], xt[:, :, :1], d, -d)


# ---------------------------------------------------------------------------
# the slice on the card: the same model and requests on CUDA (kernels) and
# on the CPU (plain versions), in fp32
# ---------------------------------------------------------------------------

def _tiny_qwen():
    from repro_torch.configs.base import ArchConfig, Segment
    return ArchConfig(name="qwen3-tiny", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab=300, qk_norm=True,
                      rope_theta=1_000_000.0,
                      pattern=(Segment(("attn",), 2),), dtype="float32",
                      param_dtype="float32")


@pytest.mark.gpu
def test_cuda_forward_matches_cpu_forward():
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.models import transformer as T
    arch = _tiny_qwen()
    params = T.init_lm(arch, device="cpu", seed=0)
    gparams = _to(params, "cuda")
    tokens = torch.randint(0, arch.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(0))
    for impl in ("xla", "pallas"):
        before = (trn.rmsnorm.launches, tfa.flash_attention.launches)
        got = T.lm_apply(gparams, arch, tokens.cuda(), impl=impl).logits
        torch.cuda.synchronize()
        want = T.lm_apply(params, arch, tokens, impl=impl).logits
        assert trn.rmsnorm.launches - before[0] == 4 * arch.n_layers + 1
        assert tfa.flash_attention.launches - before[1] == \
            (arch.n_layers if impl == "pallas" else 0)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_engine_matches_cpu_engine():
    """Greedy tokens equal and logprobs close under chunked prefill and
    forced preemption."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    arch = _tiny_qwen()
    params = T.init_lm(arch, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, size=n).astype(np.int32)
               for n in (9, 5, 13, 7)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ContinuousBatchingEngine(arch, params, device=dev, slots=2,
                                       max_len=32, block_size=4,
                                       num_blocks=7, prefill_chunk=4)
        outs[dev] = eng.generate([
            Request(id=i, prompt=p, max_new_tokens=8,
                    sampling=SamplingParams(logprobs=True))
            for i, p in enumerate(prompts)])
        assert eng.metrics.preemptions > 0
        assert eng.cache.allocator.num_used == 0
    assert [o.token_ids for o in outs["cuda"]] == \
        [o.token_ids for o in outs["cpu"]]
    for g, w in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


def _tiny_hybrid():
    from repro_torch.configs.base import ArchConfig, Segment, SSMSpec
    return ArchConfig(name="hybrid-tiny", family="hybrid", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab=300,
                      ssm=SSMSpec(d_state=64, head_dim=32, n_groups=2,
                                  chunk=16),
                      pattern=(Segment(("attn", "mamba2"), 2),),
                      dtype="float32", param_dtype="float32")


@pytest.mark.gpu
def test_cuda_hybrid_forward_and_engine_match_cpu():
    """attn + mamba2 on the card (SSD, flash and RMSNorm kernels) against
    the CPU (plain versions): forward logits, and greedy tokens under
    chunked prefill and forced preemption."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    arch = _tiny_hybrid()
    params = T.init_lm(arch, device="cpu", seed=0)
    tokens = torch.randint(0, arch.vocab, (2, 70),
                           generator=torch.Generator().manual_seed(0))
    before = tssd.ssd_scan.launches
    got = T.lm_apply(_to(params, "cuda"), arch, tokens.cuda(),
                     impl="pallas").logits
    torch.cuda.synchronize()
    assert tssd.ssd_scan.launches - before == 2
    want = T.lm_apply(params, arch, tokens, impl="pallas").logits
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, size=n).astype(np.int32)
               for n in (19, 5, 23, 7)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ContinuousBatchingEngine(arch, params, device=dev, slots=2,
                                       max_len=40, block_size=4,
                                       num_blocks=9, prefill_chunk=8)
        outs[dev] = eng.generate([
            Request(id=i, prompt=p, max_new_tokens=8,
                    sampling=SamplingParams(logprobs=True))
            for i, p in enumerate(prompts)])
        assert eng.metrics.preemptions > 0
        assert eng.cache.allocator.num_used == 0
    assert [o.token_ids for o in outs["cuda"]] == \
        [o.token_ids for o in outs["cpu"]]
    for g, w in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)


def _to(params, device):
    return tree.map(lambda t: t.to(device), params)


def _tiny_frontend_arch(kind):
    """fp32 tiny archs of the two frontend families: whisper's (``wdec``
    blocks, an encoder of 2 ``enc_attn`` blocks over 24 frames, LayerNorm,
    biases, GELU, head dim 64) and llama-vision's (``attn`` then gated
    ``cross_attn``, 16 patch tokens, GQA 2)."""
    from repro_torch.configs.base import ArchConfig, EncoderSpec, Segment
    if kind == "encdec":
        return ArchConfig(name="encdec-tiny", family="audio", n_layers=2,
                          d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                          vocab=300, act="gelu", norm="layernorm",
                          attn_bias=True, tie_embeddings=True,
                          pattern=(Segment(("wdec",), 2),),
                          encoder=EncoderSpec(n_layers=2, seq_len=24,
                                              d_ff=512),
                          frontend="audio", dtype="float32",
                          param_dtype="float32")
    return ArchConfig(name="cross-tiny", family="vlm", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab=300, frontend="vision", n_img_tokens=16,
                      pattern=(Segment(("attn", "cross_attn"), 2),),
                      dtype="float32", param_dtype="float32")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["encdec", "cross"])
def test_cuda_frontend_archs_match_cpu(kind):
    """The enc-dec and vision families on the card (flash and RMSNorm
    kernels; LayerNorm, the encoder and cross attention plain) against the
    CPU (plain versions), in fp32, each request with its own frontend and
    llama-vision's gates opened at 0.5: forward logits at 1e-4 (with its
    exact flash launches: one a causal self-attention), and greedy tokens
    equal, logprobs at 1e-4, under chunked prefill and forced
    preemption."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request
    from repro_torch.serving.sampling import SamplingParams
    arch = _tiny_frontend_arch(kind)
    params = T.init_lm(arch, device="cpu", seed=0)
    for seg in params["segments"]:
        blk = seg.get("b1", {})
        if "mlp_gate" in blk:
            blk["mlp_gate"].fill_(0.5)
            blk["attn"]["gate"].fill_(0.5)
    T_fe = arch.encoder.seq_len if arch.encoder else arch.n_img_tokens
    g = torch.Generator().manual_seed(1)
    fe = torch.randn((4, T_fe, arch.d_model), generator=g)
    tokens = torch.randint(0, arch.vocab, (2, 70), generator=g)
    before = tfa.flash_attention.launches
    got = T.lm_apply(_to(params, "cuda"), arch, tokens.cuda(),
                     frontend=fe[:2].cuda(), impl="pallas").logits
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - before == 2
    want = T.lm_apply(params, arch, tokens, frontend=fe[:2],
                      impl="pallas").logits
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, size=n).astype(np.int32)
               for n in (19, 5, 23, 7)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ContinuousBatchingEngine(arch, params, device=dev, slots=2,
                                       max_len=40, block_size=4,
                                       num_blocks=9, prefill_chunk=8)
        outs[dev] = eng.generate([
            Request(id=i, prompt=p, max_new_tokens=8, frontend=fe[i:i + 1],
                    sampling=SamplingParams(logprobs=True))
            for i, p in enumerate(prompts)])
        assert eng.metrics.preemptions > 0
        assert eng.cache.allocator.num_used == 0
    assert [o.token_ids for o in outs["cuda"]] == \
        [o.token_ids for o in outs["cpu"]]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-4)


# ---------------------------------------------------------------------------
# the Trainer on a 1 x 1 NCCL mesh, and its checkpoints, on the card
# ---------------------------------------------------------------------------

def _qwen_like(dtype="bfloat16"):
    from repro_torch.configs.base import ArchConfig, Segment
    return ArchConfig(name="qwen-gpu", family="dense", n_layers=2,
                      d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab=1000, qk_norm=True,
                      pattern=(Segment(("attn",), 2),), dtype=dtype,
                      param_dtype=dtype)


@pytest.mark.gpu
def test_cuda_trainer_on_a_1x1_nccl_mesh_matches_the_plain_step():
    """The Trainer (DTensor params on a world-1 NCCL mesh, impl="pallas")
    against the plain make_train_step on the same params and batches:
    the same kernels launched each step, the same losses."""
    _need_cuda()
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.optim import optimizers as O
    from repro_torch.optim import schedules as S
    from repro_torch.runtime import steps as ST
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    arch = _qwen_like()
    try:
        mesh = M.make_host_mesh(device="cuda")
        tr = Trainer(arch, ShapeSpec("g", 128, 2, "train"), mesh,
                     TrainConfig(lr=3e-4, warmup_steps=1, total_steps=10,
                                 impl="pallas"))
        p, o = tr.init_state()
        assert type(tree.leaves(p)[0]).__name__ == "DTensor"
        plain = tree.map(lambda x: x.full_tensor().clone(), p)
        opt = O.adamw(S.cosine_schedule(3e-4, 1, 10))
        state = opt[0](plain)
        step = ST.make_train_step(arch, opt, impl="pallas")
        want = []
        for batch in [b for b, _ in zip(SyntheticLM(1000, 128, 2), range(3))]:
            plain, state, m = step(plain, state, batch)
            want.append(float(m["loss"]))
        before = (trn.rmsnorm.launches, tfa.flash_attention.launches,
                  tfa.flash_attention_bwd.launches)
        p, o, hist = tr.train(p, o, SyntheticLM(1000, 128, 2), steps=3)
        after = (trn.rmsnorm.launches, tfa.flash_attention.launches,
                 tfa.flash_attention_bwd.launches)
        assert [a - b for a, b in zip(after, before)] == [3 * 9, 3 * 2,
                                                          3 * 2]
        got = [m["loss"] for m in hist]
        assert all(math.isfinite(x) for x in got)
        torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                                   rtol=1e-5, atol=0)
    finally:
        M.shutdown()


@pytest.mark.gpu
def test_cuda_checkpoint_bf16_round_trip_is_bit_exact(tmp_path):
    _need_cuda()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    try:
        mesh = M.make_host_mesh(device="cuda")
        tr = Trainer(_qwen_like(), ShapeSpec("g", 128, 2, "train"), mesh,
                     TrainConfig())
        p, o = tr.init_state()
        ck = CheckpointManager(tmp_path)
        ck.save(1, {"params": p, "opt": o})
        ck.wait()
        p2, o2 = tr.init_state(seed=3)
        back, manifest = ck.restore({"params": p2, "opt": o2})
        assert manifest["step"] == 1
        for a, b in zip(tree.leaves(back["params"]), tree.leaves(p)):
            assert a.dtype == torch.bfloat16 and a.device.type == "cuda"
            assert torch.equal(a.full_tensor().view(torch.int16),
                               b.full_tensor().view(torch.int16))
        for a, b in zip(tree.leaves(back["opt"].mu), tree.leaves(o.mu)):
            assert torch.equal(a.full_tensor(), b.full_tensor())
    finally:
        M.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_vit_forward_and_backward_match_plain(dtype):
    """A small ViT (65 tokens, 4 heads of 16) through the flash kernel,
    forward and backward, against the same params through the plain
    flash: logits norm-wise at the backward kernels' tolerance, grads per
    leaf by chip_smoke.py's train-phase checks (the key biases, whose
    gradient is 0 in exact arithmetic, by norm)."""
    _need_cuda()
    from unittest import mock

    from repro_torch.examples import paper_repro_asa as ASA
    from repro_torch.models import vision as V
    from repro_torch.optim import optimizers as O
    from repro_torch.runtime import steps as ST
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    cfg = V.ViTConfig(d_model=64, n_layers=2, n_heads=4, d_ff=128,
                      n_classes=10, dtype=dtype)
    params = V.init_vit(cfg, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randn((8, 32, 32, 3), generator=g,
                         device="cuda").to(DTYPES[dtype][0])
    labels = torch.randint(0, 10, (8,), generator=g, device="cuda")

    def apply(p, x):
        return V.vit_apply(p, cfg, x)
    loss_fn = ASA.image_loss(apply)
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    got = apply(params, images)
    loss_k, _, g_k = ST.loss_and_grads(loss_fn, params, images, labels)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - before[0],
            tfa.flash_attention_bwd.launches - before[1]) == (4, 2)
    with mock.patch.object(tops, "flash_attention", tref.flash_attention_ref):
        want = apply(params, images)
        loss_p, _, g_p = ST.loss_and_grads(loss_fn, params, images, labels)
    err, ok, tol = smoke.check_normwise([got], [want], dtype)
    assert ok, (err, tol)
    names = tree.names(params)
    gn = float(O.global_norm(g_p))
    diffs = smoke.grad_diffs(torch, names, g_k, g_p)
    for n, (cos, rel) in diffs.items():
        if n.endswith(smoke.ZERO_GRAD_LEAF):
            k = names.index(n)
            for gr in (g_k[k], g_p[k]):
                assert float(torch.linalg.vector_norm(gr.float())) <= \
                    smoke.ZERO_GRAD_REL_MAX * gn, n
            continue
        assert cos >= smoke.GRAD_COS_MIN and rel <= smoke.GRAD_REL_L2_MAX, \
            (n, cos, rel)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-2 * abs(float(loss_p))

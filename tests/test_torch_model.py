"""The port's model stack (``repro_torch.models`` / ``runtime.steps``)
against the JAX reference on the same params and the same inputs.

Params come from the JAX ``init_lm`` and are converted leaf for leaf
(``repro_torch.convert``); token and activation inputs are made with numpy
from a fixed seed.  Everything is float32, so logits and updated KV and
slot-state pools are held to 1e-5.  The archs: the dense and mamba2
shapes, zamba2's (``tiny-shared`` and ``reduce_for_smoke(zamba2-2.7b)``:
the weight-shared attention block over concat(x, x0) with per-application
KV pools, GeGLU) and gemma's (``gemma-tiny``: GeGLU, tied embeddings,
heads x head_dim wider than d_model), GQA at ratio 3 (``gqa3-tiny``),
and the MoE family: ``tiny-mla`` (the goldens' MLA + MoE shape) and
``reduce_for_smoke`` of deepseek-v3-671b (MLA, sigmoid routing, a shared
expert, the MTP head) and of arctic-480b (``moe_attn``: softmax routing, a
dense residual FFN).  ``moe``, ``mla_attention`` and
``mla_paged_attention`` are also held alone, the MoE layer at a capacity
that drops tokens and under ``jax.grad``.  The enc-dec and vision
families: ``tiny-encdec`` (whisper's shape: LayerNorm, an encoder of
``enc_attn`` blocks, ``wdec`` blocks with cross attention over its
output, sinusoidal positions, GELU, biases) and ``tiny-cross``
(llama-vision's: gated ``cross_attn`` blocks), run with frontends and
their gates opened (``torch_port_fixtures.GATE``); ``layernorm``,
``sinusoidal_at``, cross ``attention``, ``encode_frontend`` and
``admit_slot``'s rows are also held alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.runtime import steps as JST
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import tree as ttree
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM2
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.runtime import steps as TST
from serving_fixtures import (TINY, TINY_CROSS, TINY_ENCDEC, TINY_HYBRID,
                              TINY_MLA, TINY_SHARED, TINY_SSM)
from torch_port_fixtures import (GATE, GEMMA_TINY, GQA3_TINY, QWEN_TINY,
                                 SSM_G2_TINY, frontend, jax_params,
                                 port_arch, torch_params)

ZAMBA2_SMOKE = j_reduce_for_smoke(j_get_arch("zamba2-2.7b"))
DEEPSEEK_SMOKE = j_reduce_for_smoke(j_get_arch("deepseek-v3-671b"))
ARCTIC_SMOKE = j_reduce_for_smoke(j_get_arch("arctic-480b"))
ARCHS = {"tiny-serve": TINY, "qwen3-tiny": QWEN_TINY, "tiny-ssm": TINY_SSM,
         "tiny-hybrid": TINY_HYBRID, "tiny-ssm-g2": SSM_G2_TINY,
         "tiny-shared": TINY_SHARED, "zamba2-smoke": ZAMBA2_SMOKE,
         "gemma-tiny": GEMMA_TINY, "gqa3-tiny": GQA3_TINY,
         "tiny-mla": TINY_MLA, "deepseek-smoke": DEEPSEEK_SMOKE,
         "arctic-smoke": ARCTIC_SMOKE, "tiny-cross": TINY_CROSS,
         "tiny-encdec": TINY_ENCDEC}
TOL = 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_bit_exact(param_dtype):
    arch = QWEN_TINY.scaled(param_dtype=param_dtype)
    params = jax.tree.map(lambda a: a.astype(param_dtype),
                          jax_params(QWEN_TINY))
    host = jax.tree.map(np.asarray, params)
    tp = convert.to_torch(host)
    leaf = tp["segments"][0]["b0"]["attn"]["wq"]["w"]
    assert leaf.shape == (2, 64, 64)               # stacked repeat axis kept
    assert leaf.dtype == getattr(torch, param_dtype)
    _same_tree(host, convert.to_numpy(tp))
    cache = jax.tree.map(np.asarray, JT.init_paged_cache(arch, 5, 4))
    _same_tree(cache, convert.to_numpy(convert.to_torch(cache)))


def test_convert_carries_the_shared_block_and_its_pools():
    """zamba2's ``shared`` subtree and the per-application ``app_proj``,
    stacked on the segment's repeat axis, and the per-application KV pools
    convert as they are, bit for bit, in bf16."""
    arch = TINY_SHARED.scaled(param_dtype="bfloat16")
    host = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        jax_params(TINY_SHARED))
    tp = convert.to_torch(host)
    assert tp["shared"]["attn"]["wq"]["w"].shape == (128, 128)   # 2d wide
    assert tp["segments"][0]["b0"]["app_proj"]["w"].shape == (2, 128, 64)
    _same_tree(host, convert.to_numpy(tp))
    cache = jax.tree.map(np.asarray,
                         JT.init_paged_cache(arch, 5, 4, slots=2))
    assert cache[0]["b0"]["k"].shape == (2, 5, 4, 4, 32)   # (R, NB, BS, H, D)
    _same_tree(cache, convert.to_numpy(convert.to_torch(cache)))


@pytest.mark.parametrize("name", ["tiny-cross", "tiny-encdec"])
def test_convert_carries_the_encoder_gates_and_cross_pools(name):
    """The encoder subtree (``enc_attn`` blocks stacked on their repeat
    axis, its final norm), the tanh gates, the LayerNorm biases and the
    cross-K/V slot rows (wdec's nested in its pool) convert as they are,
    bit for bit, in bf16."""
    jarch = ARCHS[name]
    arch = jarch.scaled(param_dtype="bfloat16")
    host = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        jax_params(jarch, open_gates=True))
    tp = convert.to_torch(host)
    _same_tree(host, convert.to_numpy(tp))
    if jarch.encoder:
        enc = tp["encoder"]["segments"][0]["b0"]
        assert enc["attn"]["wq"]["b"].shape == (2, 64)    # (R, q_dim)
        assert tp["encoder"]["final_norm"]["bias"].shape == (64,)
    else:
        gate = tp["segments"][0]["b1"]["attn"]["gate"]
        assert gate.shape == (2,) and float(gate[0]) == GATE
    cache = jax.tree.map(np.asarray,
                         JT.init_paged_cache(arch, 5, 4, slots=2))
    rows = (cache[0]["b0"]["cross"] if jarch.encoder
            else cache[0]["b1"])["k"]
    T = jarch.encoder.seq_len if jarch.encoder else jarch.n_img_tokens
    assert rows.shape == (2, 3, T, jarch.n_kv_heads, 16)  # (R, slots+1, ..)
    _same_tree(cache, convert.to_numpy(convert.to_torch(cache)))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_lm_matches_reference_tree(name):
    """Same nesting, shapes and dtypes as the reference init (values are
    the port's own draws)."""
    arch = ARCHS[name]
    want = jax.tree.map(np.asarray, jax_params(arch))
    got = TT.init_lm(port_arch(arch), device="cpu", seed=0)

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    walk(want, got)
    b0 = got["segments"][0]["b0"]
    w = (b0["mlp"]["w_in"]["w"] if "mlp" in b0 else b0["moe"]["w_in"]
         if "moe" in b0 else b0["app_proj"]["w"] if "app_proj" in b0
         else b0["mixer"]["x_proj"]["w"])
    assert float(w.abs().max()) <= 2.0 / w.shape[-2] ** 0.5    # truncated
    if "moe" in b0:             # the router stays fp32 in a bf16 model
        bf = TT.init_lm(port_arch(arch.scaled(param_dtype="bfloat16")),
                        device="cpu", seed=0)["segments"][0]["b0"]["moe"]
        assert bf["router"]["w"].dtype == torch.float32
        assert bf["w_in"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-780m", "zamba2-2.7b",
                                  "gemma-7b", "minitron-4b",
                                  "command-r-plus-104b", "deepseek-v3-671b",
                                  "arctic-480b", "whisper-medium",
                                  "llama-3.2-vision-90b"])
def test_configs_and_smoke_reductions_equal_the_reference(name):
    """The port's copy of each served config, and its reduce_for_smoke,
    field for field the reference's."""
    want = j_get_arch(name)
    assert tconfigs.get_arch(name) == port_arch(want)
    assert tconfigs.reduce_for_smoke(tconfigs.get_arch(name)) == \
        port_arch(j_reduce_for_smoke(want))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_lm_apply_matches_reference(name, impl):
    """Logits, the final-normed hidden states, the MoE aux loss (0
    without MoE) and, for an MTP arch, the MTP head's logits; an arch with
    a frontend takes one (gates opened)."""
    arch = ARCHS[name]
    tokens = np.random.default_rng(0).integers(0, arch.vocab, (2, 11))
    fe = frontend(arch, 2, 1) if arch.frontend else None
    gates = arch.frontend is not None
    want = JT.lm_apply(jax_params(arch, gates), arch,
                       jnp.asarray(tokens, jnp.int32),
                       frontend=None if fe is None else jnp.asarray(fe),
                       impl=impl, return_hidden=True)
    got = TT.lm_apply(torch_params(arch, gates), port_arch(arch),
                      torch.from_numpy(tokens),
                      frontend=None if fe is None else torch.from_numpy(fe),
                      impl=impl, return_hidden=True)
    assert got.logits.shape == (2, 11, arch.padded_vocab)
    assert got.logits.dtype == torch.float32
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    assert got.aux.shape == () and got.aux.dtype == torch.float32
    _close(got.aux, want.aux)
    assert (float(got.aux) > 0) == (arch.moe is not None)
    if arch.mtp:
        _close(TT.mtp_logits(torch_params(arch), port_arch(arch), got.hidden,
                             torch.from_numpy(tokens)),
               JT.mtp_logits(jax_params(arch), arch, want.hidden,
                             jnp.asarray(tokens, jnp.int32)))


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu", "relu"])
def test_mlp_matches_reference(act):
    """Each act the reference's ``mlp`` takes, on its own init (gated acts
    carry ``w_gate``); GELU is the tanh form in both."""
    jp = JL.init_mlp(jax.random.PRNGKey(1), 48, 80, act=act)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    assert ("w_gate" in tp) == (act in ("silu", "geglu"))
    x = np.random.default_rng(8).standard_normal((2, 5, 48)).astype(np.float32)
    want = JL.mlp(jp, jnp.asarray(x) * 3, act)
    _close(TL.mlp(tp, torch.from_numpy(x) * 3, act), want)
    tinit = TL.init_mlp(48, 80, act=act, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert sorted(tinit) == sorted(tp)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_shared_block_grads_match_jax_grad(remat):
    """zamba2's shared block (one set of weights, two applications on
    TINY_SHARED) under grad: the grads of the shared params, and of each
    application's app_proj, with sum(logits * cotangent) as the loss,
    against jax.grad of the reference's lm_apply at 1e-5 of each grad's
    max; under remat="full" each application's checkpointed body closes
    over the shared params, and autograd still sums their grads."""
    arch = TINY_SHARED
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, arch.vocab, (2, 9))
    cot = rng.standard_normal((2, 9, arch.padded_vocab)).astype(np.float32)

    def jloss(p):
        out = JT.lm_apply(p, arch, jnp.asarray(tokens, jnp.int32))
        return jnp.sum(out.logits * cot)
    want = jax.grad(jloss)(jax_params(arch))

    tp = convert.to_torch(jax.tree.map(np.asarray, jax_params(arch)))
    shared = _flat(tp["shared"])
    proj = tp["segments"][0]["b0"]["app_proj"]["w"]
    for t in list(shared.values()) + [proj]:
        t.requires_grad_()
    logits = TT.lm_apply(tp, port_arch(arch), torch.from_numpy(tokens),
                         remat=remat).logits
    (logits * torch.from_numpy(cot)).sum().backward()
    assert len(shared) == 9     # 2 norms, wq/wk/wv/wo, w_in/w_gate/w_out
    for k, t in shared.items():
        _close_scaled(t.grad, _get(want["shared"], k), k)
    _close_scaled(proj.grad, want["segments"][0]["b0"]["app_proj"]["w"],
                  "app_proj")


@pytest.mark.parametrize("S,T", [(7, 7), (5, 9), (1100, 1100)])
def test_sdpa_dense_and_chunked_match_reference(S, T):
    """S*T > 1024^2 with S > 512 takes the q-block-chunked path."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, S, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, T, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, T, 1, 8)).astype(np.float32)
    for causal in (True, False):
        want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, scale=0.3)
        got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal, scale=0.3)
        _close(got, want)


def test_rope_and_paged_indices_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.asarray([[3, 4, 5, 6, 7], [90, 91, 92, 93, 94]])
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    # row 1 runs past its 3-block table (overrun -> null block scratch
    # rows); row 0 has padding past new_lens
    tables = np.asarray([[4, 2, 7], [1, 5, 3]], np.int32)
    positions = np.asarray([2, 9], np.int32)
    new_lens = np.asarray([3, 5], np.int32)
    jq, jf = JL.paged_flat_indices(jnp.asarray(positions), 5,
                                   jnp.asarray(tables), 4,
                                   new_lens=jnp.asarray(new_lens))
    tq, tf = TL.paged_flat_indices(torch.from_numpy(positions), 5,
                                   torch.from_numpy(tables), 4,
                                   new_lens=torch.from_numpy(new_lens))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_paged_prefill_and_decode_steps_match_reference(name):
    """Two padded prompt chunks then three decode steps (with an idle row
    on the null block), on shuffled block tables: logits after every step
    and the pools after every step (null block excluded — padded rows'
    scratch writes may land there in any order) match the JAX steps.  An
    arch with a frontend first admits one into each slot row it uses
    (gates opened), and its rows must match after admission too."""
    arch = ARCHS[name]
    tarch = port_arch(arch)
    NB, BS, C, SLOTS = 12, 4, 6, 3
    jcache = JT.init_paged_cache(arch, NB, BS, jnp.float32, slots=SLOTS)
    tcache = convert.to_torch(jax.tree.map(np.asarray, jcache))
    jpre = JST.make_paged_prefill_step(arch)
    jdec = JST.make_paged_decode_step(arch)
    tpre = TST.make_paged_prefill_step(tarch)
    tdec = TST.make_paged_decode_step(tarch)
    gates = arch.frontend is not None
    jp, tp = jax_params(arch, gates), torch_params(arch, gates)
    rng = np.random.default_rng(3)
    tables = np.asarray([[3, 7, 1, 9], [2, 5, 11, 4]], np.int32)
    # slot-state pool rows, out of order; the idle decode row takes the
    # null row (= SLOTS)
    sids = np.asarray([2, 0], np.int32)
    sids3 = np.asarray([2, 0, SLOTS], np.int32)

    def pools_close():
        """Paged KV pools without the null block (row 1 of the block
        axis on), mamba2 state pools without the null row (the last):
        padded and idle rows write scratch there in any order.  Cross-K/V
        rows are written at admission only, and held whole."""
        for seg, js, ts in zip(arch.pattern, jcache, tcache):
            for bi, kind in enumerate(seg.blocks):
                key = f"b{bi}"
                parts = ([("self", slice(1, None)), ("cross", slice(None))]
                         if kind == "wdec" else
                         [(None, slice(None, -1) if kind == "mamba2" else
                           slice(None) if kind == "cross_attn" else
                           slice(1, None))])
                for part, skip in parts:
                    tpool = ts[key] if part is None else ts[key][part]
                    jpool = js[key] if part is None else js[key][part]
                    for leaf, t in tpool.items():
                        _close(t[:, skip], np.asarray(jpool[leaf])[:, skip])

    if arch.frontend:
        fe = frontend(arch, 2, 4)
        for i, slot in enumerate(sids):
            jcache = JT.admit_slot(jp, arch, jcache, int(slot),
                                   frontend=jnp.asarray(fe[i:i + 1]))
            TT.admit_slot(tp, tarch, tcache, int(slot),
                          frontend=torch.from_numpy(fe[i:i + 1]))
        pools_close()

    pos = np.asarray([0, 0], np.int32)
    for new_lens in ([6, 4], [5, 6]):
        toks = rng.integers(0, arch.vocab, (2, C)).astype(np.int32)
        nl = np.asarray(new_lens, np.int32)
        want, jcache = jpre(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(tables), jnp.asarray(nl),
                            jnp.asarray(sids))
        got, out = tpre(tp, tcache, torch.from_numpy(toks),
                        torch.from_numpy(pos), torch.from_numpy(tables),
                        torch.from_numpy(nl), torch.from_numpy(sids))
        assert out is tcache                          # pools updated in place
        _close(got, want)
        pools_close()
        pos = pos + nl

    tables3 = np.concatenate([tables, np.zeros((1, 4), np.int32)])
    for _ in range(3):
        toks = rng.integers(0, arch.vocab, (3, 1)).astype(np.int32)
        p3 = np.concatenate([pos, [0]]).astype(np.int32)
        want, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(p3),
                            jnp.asarray(tables3), jnp.asarray(sids3))
        got, _ = tdec(tp, tcache, torch.from_numpy(toks),
                      torch.from_numpy(p3), torch.from_numpy(tables3),
                      torch.from_numpy(sids3))
        _close(got[:2], np.asarray(want)[:2])
        pools_close()
        pos = pos + 1


def _conv_params(rng, K, C):
    w = rng.standard_normal((K, C)).astype(np.float32) * 0.5
    b = rng.standard_normal((C,)).astype(np.float32) * 0.1
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)})


@pytest.mark.parametrize("left", [False, True])
def test_causal_conv_matches_reference(left):
    rng = np.random.default_rng(4)
    K, C = 4, 12
    jc, tc = _conv_params(rng, K, C)
    u = rng.standard_normal((2, 7, C)).astype(np.float32)
    buf = rng.standard_normal((2, K - 1, C)).astype(np.float32)
    want = JM2._causal_conv(jnp.asarray(u), jc,
                            left=jnp.asarray(buf) if left else None)
    got = TM2._causal_conv(torch.from_numpy(u), tc,
                           left=torch.from_numpy(buf) if left else None)
    _close(got, want)


@pytest.mark.parametrize("new_lens", [None, [7, 2], [1, 0]])
def test_conv_tail_matches_reference(new_lens):
    """new_lens below d_conv-1 (2, 1, 0) take part of the old buffer."""
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((2, 3, 5)).astype(np.float32)
    raw = rng.standard_normal((2, 7, 5)).astype(np.float32)
    nl = None if new_lens is None else np.asarray(new_lens, np.int32)
    want = JM2._conv_tail(jnp.asarray(buf), jnp.asarray(raw),
                          None if nl is None else jnp.asarray(nl))
    got = TM2._conv_tail(torch.from_numpy(buf), torch.from_numpy(raw),
                         None if nl is None else torch.from_numpy(nl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_step_matches_reference():
    rng = np.random.default_rng(6)
    K, C = 4, 12
    jc, tc = _conv_params(rng, K, C)
    buf = rng.standard_normal((3, K - 1, C)).astype(np.float32)
    u = rng.standard_normal((3, 1, C)).astype(np.float32)
    want_out, want_buf = JM2._conv_step(jnp.asarray(u), jnp.asarray(buf), jc)
    got_out, got_buf = TM2._conv_step(torch.from_numpy(u),
                                      torch.from_numpy(buf), tc)
    _close(got_out, want_out)
    np.testing.assert_array_equal(got_buf.numpy(), np.asarray(want_buf))


def test_greedy_sampler_cuts_padded_vocab():
    from repro_torch.serving.sampling import make_sampler
    logits = torch.zeros((2, 512))
    logits[0, 400] = 5.0                       # padding column: never wins
    logits[0, 7] = 1.0
    logits[1, 299] = 2.0
    sample = make_sampler(300)
    z = np.zeros(2, np.float32)
    tok, logp = sample(logits, z, z.astype(np.int32), z + 1, z, z)
    assert tok.tolist() == [7, 299]
    want = torch.log_softmax(logits[:, :300], -1)[[0, 1], [7, 299]]
    torch.testing.assert_close(logp, want)
    # a stochastic row at top_k = 1 keeps only the argmax: the padding
    # column is cut before the mask, so it still never wins
    tok, _ = sample(logits, z + 0.5, np.ones(2, np.int32), z + 1,
                    z.astype(np.uint32), torch.zeros(2, dtype=torch.int64))
    assert tok.tolist() == [7, 299]
    with pytest.raises(ValueError, match="seeds"):
        sample(logits, z + 0.5, None, None, None, torch.zeros(2))


def _mixer_case(seed, cached):
    """A mamba2 mixer (d_model 64, 8 heads of 16, d_state 16, two groups,
    chunk 8) with the reference's init, x and the output cotangents from
    numpy; ``cached``: a random carried state and conv buffers, and rows
    past new_lens = (20, 13) padding."""
    cfg = dict(d_model=64, d_state=16, head_dim=16, n_groups=2, chunk=8)
    jcfg, tcfg = JM2.Mamba2Config(**cfg), TM2.Mamba2Config(**cfg)
    jp = JM2.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    B, S = 2, 20
    arrays = {"x": rng.standard_normal((B, S, 64)).astype(np.float32),
              "gy": rng.standard_normal((B, S, 64)).astype(np.float32),
              "gh": rng.standard_normal((B, 8, 16, 16)).astype(np.float32)}
    cache = None
    if cached:
        cache = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
                 for k, v in JM2.init_mamba2_cache(jcfg, B).items()}
    return jcfg, tcfg, jp, arrays, cache


@pytest.mark.parametrize("cached", [False, True])
def test_mamba2_mixer_grads_match_jax_grad(cached):
    """The mixer under grad, as training runs it (``cached``: also from a
    carried state and conv buffers, with padded rows past new_lens, whose
    dt is zeroed by a select): the grads of every param, of x and of the
    carried state and buffers, with sum(y·gy) (+ sum(h_final·gh)) as the
    loss, against jax.grad of the reference's mixer at 1e-5."""
    jcfg, tcfg, jp, arr, cache = _mixer_case(7, cached)
    nl = np.asarray([20, 13], np.int32) if cached else None

    def jloss(p, x, c):
        y, nc = JM2.mamba2(p, jcfg, x, cache=c,
                           new_lens=None if nl is None else jnp.asarray(nl))
        out = jnp.sum(y * arr["gy"])
        return out + (jnp.sum(nc["ssm"] * arr["gh"]) if c is not None
                      else 0.0)
    jc = None if cache is None else jax.tree.map(jnp.asarray, cache)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(arr["x"]), jc)

    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_()
    x = torch.from_numpy(arr["x"]).requires_grad_()
    tc = None if cache is None else {
        k: torch.from_numpy(v).requires_grad_() for k, v in cache.items()}
    y, nc = TM2.mamba2(tp, tcfg, x, cache=tc,
                       new_lens=None if nl is None else torch.from_numpy(nl))
    loss = (y * torch.from_numpy(arr["gy"])).sum()
    if tc is not None:
        loss = loss + (nc["ssm"] * torch.from_numpy(arr["gh"])).sum()
    loss.backward()
    for k, t in leaves.items():
        _close_scaled(t.grad, _get(want[0], k), k)
    _close_scaled(x.grad, want[1], "x")
    if tc is not None:
        for k, t in tc.items():
            _close_scaled(t.grad, want[2][k], k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _close_scaled(got, want, what, tol=TOL):
    """max |got - want| <= tol * max |want| (grads are sums of many
    products; an elementwise rtol fails near 0 on summation order)."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# MoE and MLA alone
# ---------------------------------------------------------------------------

# (router, capacity factor, shared expert, dense residual): arctic's and
# deepseek's layers at a capacity of a whole row (C = S, nothing dropped),
# and at the published 1.25 and at 0.5, which drop assignments
MOE_CASES = {"softmax-dense": ("softmax", 2.0, False, True),
             "sigmoid-shared": ("sigmoid", 2.0, True, False),
             "softmax-drops": ("softmax", 1.25, False, True),
             "sigmoid-drops": ("sigmoid", 0.5, True, False)}


def _moe_case(name, seed=4):
    router, cf, shared, dense = MOE_CASES[name]
    cfg = dict(d_model=32, d_ff=24, n_experts=4, top_k=2, router=router,
               capacity_factor=cf, n_shared_experts=int(shared),
               shared_d_ff=16 if shared else 0,
               dense_d_ff=20 if dense else 0)
    jcfg, tcfg = JMOE.MoEConfig(**cfg), TMOE.MoEConfig(**cfg)
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((2, 9, 32)).astype(
        np.float32)
    return jcfg, tcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp)), x


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_matches_reference(name):
    """Output and aux loss at 1e-5 in fp32.  At capacity factors 1.25 and
    0.5 (C = 5 and 2 slots an expert for a row's 9 x 2 assignments over 4
    experts) assignments are dropped, and the outputs agree only if the
    port drops the same ones; at 2.0 (C = 9) none is."""
    jcfg, tcfg, jp, tp, x = _moe_case(name)
    want, jaux = JMOE.moe(jp, jcfg, jnp.asarray(x))
    got, aux = TMOE.moe(tp, tcfg, torch.from_numpy(x))
    _close(got, want)
    _close(aux, jaux)
    assert sorted(tp) == sorted(TMOE.init_moe(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    _, _, idx = TMOE.route(tp, tcfg, torch.from_numpy(x))
    C = max(1, int(tcfg.capacity_factor * 2 * 9 / 4))
    counts = torch.nn.functional.one_hot(idx, 4).sum(dim=(1, 2))  # (B, E)
    kept = int(torch.clamp(counts, max=C).sum())
    assert (kept < idx.numel()) == name.endswith("drops")


@pytest.mark.parametrize("name", ["softmax-drops", "sigmoid-shared"])
def test_moe_grads_match_jax_grad(name):
    """Grads of every leaf and of x for sum(out * cot) + aux against
    jax.grad, each at 1e-5 of its max |grad|: the aux term reaches the
    router through p_e only, and dropped assignments take no gradient."""
    jcfg, tcfg, jp, tp, x = _moe_case(name, seed=5)
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        out, aux = JMOE.moe(p, jcfg, xx)
        return jnp.sum(out * cot) + aux
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TMOE.moe(tp, tcfg, tx)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    for k, t in leaves.items():
        _close_scaled(t.grad, _get(gp, k), k)
    _close_scaled(tx.grad, gx, "x")


def _mla_case(seed=7, r=16, H=2):
    cfg = dict(d_model=32, n_heads=H, q_lora_rank=24, kv_lora_rank=r,
               qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
               rope_theta=1e4)
    jcfg, tcfg = JMLA.MLAConfig(**cfg), TMLA.MLAConfig(**cfg)
    jp = JMLA.init_mla(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.to_torch(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("S", [7, 1100])
def test_mla_attention_matches_reference(S):
    """Whole-sequence latent attention at 1e-5; S = T = 1100 (S*T > 1024^2,
    S > MLA_CHUNK) takes the q-block scan, the last block padded.  Then
    over a contiguous latent cache of S + 4 rows: the output, the
    latents written at pos and the advanced pos as the reference's."""
    jcfg, tcfg, jp, tp = _mla_case()
    x = np.random.default_rng(S).standard_normal((1, S, 32)).astype(
        np.float32)
    want, _ = JMLA.mla_attention(jp, jcfg, jnp.asarray(x))
    got, cache = TMLA.mla_attention(tp, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want)
    jc = JMLA.init_mla_cache(jcfg, 1, S + 4, jnp.float32)
    tc = TMLA.init_mla_cache(tcfg, 1, S + 4, device="cpu",
                             dtype=torch.float32)
    want, jc = JMLA.mla_attention(jp, jcfg, jnp.asarray(x), cache=jc)
    got, cache = TMLA.mla_attention(tp, tcfg, torch.from_numpy(x), cache=tc)
    assert cache is tc and int(tc["pos"]) == int(jc["pos"]) == S
    _close(got, want)
    _close(tc["c_kv"], jc["c_kv"])
    _close(tc["k_rope"], jc["k_rope"])


def test_mla_paged_attention_matches_reference():
    """Two calls over shuffled block tables: a padded prompt chunk (row 0
    padded past new_lens) and then a step in which row 1 runs past its
    3-block table (its overrun row diverts to the null block).  Outputs
    and the latent pools (null block excluded) at 1e-5; the pools are
    written in place."""
    jcfg, tcfg, jp, tp = _mla_case(seed=8)
    NB, BS = 9, 4
    jcache = JMLA.init_paged_mla_cache(jcfg, NB, BS, jnp.float32)
    tcache = TMLA.init_paged_mla_cache(tcfg, NB, BS, device="cpu",
                                       dtype=torch.float32)
    tables = np.asarray([[4, 2, 7], [1, 5, 3]], np.int32)
    rng = np.random.default_rng(9)
    for positions, new_lens, S in (([0, 0], [3, 5], 5), ([3, 9], None, 4)):
        x = rng.standard_normal((2, S, 32)).astype(np.float32)
        pos = np.asarray(positions, np.int32)
        nl = None if new_lens is None else np.asarray(new_lens, np.int32)
        want, jcache = JMLA.mla_paged_attention(
            jp, jcfg, jnp.asarray(x), cache=jcache,
            positions=jnp.asarray(pos), block_tables=jnp.asarray(tables),
            new_lens=None if nl is None else jnp.asarray(nl))
        got, out = TMLA.mla_paged_attention(
            tp, tcfg, torch.from_numpy(x), cache=tcache,
            positions=torch.from_numpy(pos),
            block_tables=torch.from_numpy(tables),
            new_lens=None if nl is None else torch.from_numpy(nl))
        assert out is tcache
        _close(got, want)
        for leaf in ("c_kv", "k_rope"):
            _close(tcache[leaf][1:], np.asarray(jcache[leaf])[1:])


# ---------------------------------------------------------------------------
# the enc-dec and vision layers alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """fp32 math over the population variance (jnp.var's), cast back to
    the input's dtype: in fp32 at 1e-5; from bf16 input within one bf16
    rounding of the output (2^-7 of it), where both round the same fp32
    value.  torch's layer_norm (also the population variance) agrees."""
    rng = np.random.default_rng(10)
    x = (3 + 2 * rng.standard_normal((3, 5, 48))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(48)).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JL.layernorm(jax.tree.map(jnp.asarray, p), jx)
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        _close(got, want)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=1e-5, rtol=2.0 ** -7)
    lib = torch.nn.functional.layer_norm(
        tx.float(), (48,), torch.from_numpy(p["scale"]),
        torch.from_numpy(p["bias"]), 1e-5).to(tx.dtype)
    np.testing.assert_allclose(_np(got), _np(lib), atol=1e-5, rtol=2.0 ** -7)
    init = TL.init_layernorm(48, device="cpu", repeat=3)
    assert init["scale"].shape == init["bias"].shape == (3, 48)


@pytest.mark.parametrize("d_model", [64, 33])
def test_sinusoidal_at_matches_reference(d_model):
    """Sin in the even columns, cos in the odd ones (at an odd width one
    sin column more), at positions up to whisper's 1,500 frames; the
    per-row (B, S) form the paged path takes is each row's (S,) one."""
    pos = np.asarray([0, 1, 7, 383, 447, 1499], np.int32)
    want = JT.sinusoidal_at(jnp.asarray(pos), d_model)
    got = TT.sinusoidal_at(torch.from_numpy(pos), d_model)
    assert got.shape == (6, d_model) and got.dtype == torch.float32
    _close(got, want)
    rows = torch.from_numpy(np.stack([pos, pos[::-1].copy()]))
    both = TT.sinusoidal_at(rows, d_model)
    torch.testing.assert_close(both[1], TT.sinusoidal_at(rows[1], d_model))
    _close(TT.sinusoidal_positions(9, d_model),
           JT.sinusoidal_positions(9, d_model))


@pytest.mark.parametrize("gated,n_kv", [(False, 2), (True, 2), (True, 4)])
def test_cross_attention_matches_reference(gated, n_kv):
    """Cross attention over kv_input (T = 7 rows, S = 5 queries, 4 heads
    over n_kv KV heads, qk-norm, biases) against the reference's
    ``attention``; then over the same K/V handed in as precomputed rows
    (the serving path's ``cache`` without "pos"), which give the same
    output.  Gated: the output scaled by tanh(gate), gate = 0.5."""
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=n_kv, head_dim=8,
               use_rope=False, qk_norm=True, causal=False, bias=True,
               gated=gated)
    jcfg, tcfg = JL.AttnConfig(**cfg), TL.AttnConfig(**cfg)
    jp = JL.init_attention(jax.random.PRNGKey(11), jcfg)
    if gated:
        jp["gate"] = jnp.asarray(GATE, jnp.float32)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    assert ("gate" in tp) == gated
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 7, 32)).astype(np.float32)
    want, _ = JL.attention(jp, jcfg, jnp.asarray(x),
                           kv_input=jnp.asarray(kv))
    got, cache = TL.attention(tp, tcfg, torch.from_numpy(x),
                              kv_input=torch.from_numpy(kv))
    assert cache is None
    _close(got, want)
    tkv = torch.from_numpy(kv)
    k = TL.dense(tp["wk"], tkv).reshape(2, 7, n_kv, 8)
    rows = {"k": TL.rmsnorm(tp["k_norm"], k),
            "v": TL.dense(tp["wv"], tkv).reshape(2, 7, n_kv, 8)}
    again, same = TL.attention(tp, tcfg, torch.from_numpy(x), cache=rows)
    assert same is rows
    _close(again, want)
    jrows = jax.tree.map(lambda t: jnp.asarray(_np(t)), rows)
    _close(again, JL.attention(jp, jcfg, jnp.asarray(x), cache=jrows)[0])


def test_encode_frontend_matches_reference():
    """whisper's encoder at tiny-encdec's widths: frame embeddings plus
    sinusoidal positions through two bidirectional ``enc_attn`` blocks
    (LayerNorm, biases, GELU) and the final LayerNorm, at 1e-5."""
    arch = TINY_ENCDEC
    fe = frontend(arch, 2, 12)
    want = JT.encode_frontend(jax_params(arch), arch, jnp.asarray(fe))
    got = TT.encode_frontend(torch_params(arch), port_arch(arch),
                             torch.from_numpy(fe), impl="pallas")
    assert got.shape == fe.shape
    _close(got, want)


@pytest.mark.parametrize("name", ["tiny-cross", "tiny-encdec"])
def test_admit_slot_rows_match_reference(name):
    """Admission with a frontend writes the slot's cross-K/V rows in every
    layer (the patch embeddings' projections, or the encoder output's),
    in place, as the reference's ``admit_slot``; admission without one
    zeroes them; the other slots' rows and the paged pools stay."""
    arch = ARCHS[name]
    tarch = port_arch(arch)
    jcache = JT.init_paged_cache(arch, 5, 4, jnp.float32, slots=3)
    tcache = convert.to_torch(jax.tree.map(np.asarray, jcache))
    jp, tp = jax_params(arch), torch_params(arch)
    fe = frontend(arch, 2, 13)
    for slot, f in ((1, fe[:1]), (2, fe[1:]), (1, None)):
        jcache = JT.admit_slot(jp, arch, jcache, slot,
                               frontend=None if f is None else jnp.asarray(f))
        out = TT.admit_slot(tp, tarch, tcache, slot,
                            frontend=None if f is None
                            else torch.from_numpy(f))
        assert out is tcache
        for a, b in zip(jax.tree.leaves(jcache), ttree.leaves(tcache)):
            _close(b, a)
    rows = (tcache[0]["b0"]["cross"] if arch.encoder else tcache[0]["b1"])
    assert float(rows["k"][:, 2].abs().max()) > 0       # slot 2 kept its rows
    assert float(rows["k"][:, 1].abs().max()) == 0      # slot 1 zeroed

"""The port's continuous-batching engine (``repro_torch.serving``) on the CPU
against the greedy goldens (tests/goldens_serving.json) and against the JAX
engine, with the reference's params converted leaf for leaf.

The goldens were frozen under the old threefry RNG, so the params are built
inside ``jax.threefry_partitionable(False)`` (tests/torch_port_fixtures.py).
The engine kwargs are those of tests/test_serving.py for the same
scenarios; tokens must match exactly.  The ``shared/*`` scenarios serve
zamba2's shape (TINY_SHARED: the weight-shared attention block with a
paged KV pool per application, mamba2 slot state, GeGLU), the ``mla/*``
scenarios deepseek's (TINY_MLA: latent attention on paged c_kv / k_rope
pools, an ``mla_dense`` then an ``mla`` block with a MoE FFN), the
``cross/*`` scenario llama-vision's (TINY_CROSS: gated cross attention
over slot rows) and the ``encdec/*`` scenarios whisper's (TINY_ENCDEC:
paged decoder self-attention, the encoder's cross K/V in slot rows).  The
goldens were frozen without frontends and with the gates shut, so the
requests that carry frontends, with the gates opened, are held against
the JAX engine instead.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig, EncoderSpec, Segment
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import ContinuousBatchingEngine, Request
from repro_torch.serving.sampling import SamplingParams
from serving_fixtures import (TINY, TINY_CROSS, TINY_ENCDEC, TINY_MLA,
                              TINY_SHARED, TINY_SSM, load_goldens,
                              scenario_requests)
from torch_port_fixtures import (QWEN_TINY, SSM_G2_TINY, frontend,
                                 jax_params, port_arch, torch_params)


def _engine(arch, open_gates=False, **kw):
    return ContinuousBatchingEngine(port_arch(arch),
                                    torch_params(arch, open_gates),
                                    device="cpu", **kw)


def _run_scenario(name, **engine_kw):
    arch, reqs, slots, max_len = scenario_requests(name)
    eng = _engine(arch, slots=slots, max_len=max_len, **engine_kw)
    outs = eng.generate([Request(id=rid, prompt=p.copy(), max_new_tokens=m)
                         for rid, p, m in reqs])
    return eng, {o.request_id: o.token_ids for o in outs}


GOLDEN_CASES = [
    ("tiny/base",    dict(block_size=4, prefill_chunk=3), False),
    ("tiny/preempt", dict(block_size=4, num_blocks=8, prefill_chunk=8), True),
    ("tiny/victims", dict(block_size=16, num_blocks=7, prefill_chunk=16),
     True),
    ("tiny/mixed",   dict(block_size=4, prefill_chunk=8), False),
    ("ssm/base",     dict(block_size=4, prefill_chunk=3), False),
    ("hybrid/base",  dict(block_size=4, prefill_chunk=4), False),
    ("hybrid/preempt", dict(block_size=4, num_blocks=8, prefill_chunk=8),
     True),
    ("shared/base",  dict(block_size=4, prefill_chunk=3), False),
    ("shared/preempt", dict(block_size=4, num_blocks=8, prefill_chunk=8),
     True),
    ("mla/base",     dict(block_size=4, prefill_chunk=3), False),
    ("mla/preempt",  dict(block_size=4, num_blocks=8, prefill_chunk=8),
     True),
    ("cross/base",   dict(block_size=4, prefill_chunk=4), False),
    ("encdec/base",  dict(block_size=4, prefill_chunk=3), False),
    ("encdec/preempt", dict(block_size=4, num_blocks=8, prefill_chunk=8),
     True),
]


@pytest.mark.parametrize("scenario,kw,preempts", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_greedy_goldens(scenario, kw, preempts):
    eng, got = _run_scenario(scenario, **kw)
    assert got == load_goldens(scenario), scenario
    assert (eng.metrics.preemptions > 0) == preempts
    assert eng.cache.allocator.num_used == 0          # every block returned
    assert not any(s.busy for s in eng.slots)         # every slot row free
    assert eng.metrics.summary()["completed"] == len(got)


SHARING_CASES = [
    ("tiny/base",    dict(block_size=4, prefill_chunk=3)),
    ("tiny/preempt", dict(block_size=4, num_blocks=8, prefill_chunk=8)),
    ("mla/base",     dict(block_size=4, prefill_chunk=3)),
    ("mla/preempt",  dict(block_size=4, num_blocks=8, prefill_chunk=8)),
]


@pytest.mark.parametrize("scenario,kw", SHARING_CASES,
                         ids=[c[0] for c in SHARING_CASES])
def test_greedy_goldens_with_prefix_sharing(scenario, kw):
    eng, got = _run_scenario(scenario, share_prefix=True, **kw)
    assert got == load_goldens(scenario), scenario
    if scenario.endswith("preempt"):
        assert eng.metrics.preemptions > 0
        assert eng.cache.prefix_stats()["hit_tokens"] > 0
    # after drain no request holds blocks; only the content index does
    assert eng.cache.allocator.num_used == eng.cache.num_cached
    assert eng.metrics.summary()["prefix_hit_rate"] \
        == pytest.approx(eng.cache.prefix_stats()["hit_rate"])


def test_shared_prefix_skips_prefill_and_matches_unshared_outputs():
    prefix = np.arange(1, 13, dtype=np.int32)       # 3 full blocks of 4
    prompts = [np.concatenate([prefix, np.asarray([50 + i, 60 + i],
                                                  np.int32)])
               for i in range(4)]

    def serve(share):
        eng = _engine(TINY, slots=2, max_len=64, block_size=4,
                      prefill_chunk=4, share_prefix=share)
        for i, p in enumerate(prompts):
            eng.submit(Request(id=i, prompt=p.copy(), max_new_tokens=5))
        eng.run_until_drained()
        return eng, {o.request_id: o.token_ids for o in eng.completed}

    eng_off, out_off = serve(False)
    eng_on, out_on = serve(True)
    assert out_on == out_off
    # requests 0 and 1 are admitted together and prefill privately; 2 and 3
    # match the full prefix
    assert eng_on.cache.prefix_stats()["hit_tokens"] == 2 * len(prefix)
    assert eng_off.cache.prefix_stats()["hit_tokens"] == 0
    assert eng_on.metrics.prefill_chunks < eng_off.metrics.prefill_chunks


def test_matches_jax_engine_on_qwen_shaped_config():
    """qk-norm, rope theta 1e6, GQA and a padded vocab (300 -> 512):
    the port's engine and the JAX engine emit the same greedy tokens and
    logprobs under chunked prefill and forced preemption."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSamplingParams

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, QWEN_TINY.vocab, size=n).astype(np.int32)
               for n in (9, 5, 13, 7)]
    kw = dict(slots=2, max_len=32, block_size=4, num_blocks=7,
              prefill_chunk=4)
    jeng = JaxEngine(QWEN_TINY, jax_params(QWEN_TINY), make_host_mesh(), **kw)
    want = jeng.generate([
        JaxRequest(id=i, prompt=p, max_new_tokens=8,
                   sampling=JaxSamplingParams(logprobs=True))
        for i, p in enumerate(prompts)])
    teng = _engine(QWEN_TINY, **kw)
    got = teng.generate([Request(id=i, prompt=p, max_new_tokens=8,
                                 sampling=SamplingParams(logprobs=True))
                         for i, p in enumerate(prompts)])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert all(t < QWEN_TINY.vocab for o in got for t in o.token_ids)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0


def test_matches_jax_engine_on_grouped_ssm_config():
    """Pure mamba2 with two B/C groups and a scan chunk of 4: the port's
    engine and the JAX engine emit the same greedy tokens, logprobs to
    1e-5 and the same preemption count under chunked prefill and forced
    preemption (re-admission zeroes the slot row, and the re-prefill
    carries h0 and the conv buffers across chunks)."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSamplingParams

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, SSM_G2_TINY.vocab, size=n).astype(np.int32)
               for n in (9, 5, 13, 7)]
    kw = dict(slots=2, max_len=32, block_size=4, num_blocks=7,
              prefill_chunk=5)
    jeng = JaxEngine(SSM_G2_TINY, jax_params(SSM_G2_TINY), make_host_mesh(),
                     **kw)
    want = jeng.generate([
        JaxRequest(id=i, prompt=p, max_new_tokens=8,
                   sampling=JaxSamplingParams(logprobs=True))
        for i, p in enumerate(prompts)])
    teng = _engine(SSM_G2_TINY, **kw)
    got = teng.generate([Request(id=i, prompt=p, max_new_tokens=8,
                                 sampling=SamplingParams(logprobs=True))
                         for i, p in enumerate(prompts)])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
    assert teng.cache.allocator.num_used == 0


def test_matches_jax_engine_on_shared_block_config():
    """zamba2's shape (TINY_SHARED): the port's engine and the JAX engine
    emit the same greedy tokens, logprobs to 1e-5 and the same preemption
    count under chunked prefill and forced preemption (each application
    of the shared block re-prefills its own KV pool)."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSamplingParams

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, TINY_SHARED.vocab, size=n).astype(np.int32)
               for n in (9, 5, 13, 7)]
    kw = dict(slots=2, max_len=32, block_size=4, num_blocks=7,
              prefill_chunk=5)
    jeng = JaxEngine(TINY_SHARED, jax_params(TINY_SHARED), make_host_mesh(),
                     **kw)
    want = jeng.generate([
        JaxRequest(id=i, prompt=p, max_new_tokens=8,
                   sampling=JaxSamplingParams(logprobs=True))
        for i, p in enumerate(prompts)])
    teng = _engine(TINY_SHARED, **kw)
    got = teng.generate([Request(id=i, prompt=p, max_new_tokens=8,
                                 sampling=SamplingParams(logprobs=True))
                         for i, p in enumerate(prompts)])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
    assert teng.cache.allocator.num_used == 0


def test_prefix_sharing_is_refused_for_slot_state_archs():
    with pytest.raises(ValueError, match="prefix sharing cannot serve"):
        _engine(TINY_SSM, slots=2, max_len=64, share_prefix=True)


def test_prefix_sharing_is_refused_for_the_shared_block_arch():
    """zamba2's shape carries mamba2 slot state beside its paged pools, so
    prefix sharing is refused, as the reference refuses it."""
    with pytest.raises(ValueError, match=r"prefix sharing cannot serve.*"
                                         r"\['mamba2'\]"):
        _engine(TINY_SHARED, slots=2, max_len=64, share_prefix=True)


def test_stochastic_sampling_is_refused_at_submit():
    eng = _engine(TINY, slots=2, max_len=64)
    with pytest.raises(NotImplementedError, match="temperature"):
        eng.submit(Request(id=0, prompt=np.arange(1, 5, dtype=np.int32),
                           sampling=SamplingParams(temperature=0.7)))
    assert not eng.has_work
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(Request(id=1, prompt=np.arange(1, 5, dtype=np.int32),
                           sampling=SamplingParams(temperature=-1.0)))


@pytest.mark.parametrize("blocks,encoder,error,match", [
    (("attn", "bogus"), False, NotImplementedError, "bogus"),
    (("attn", "enc_attn"), False, ValueError, "enc_attn"),
    (("attn", "cross_attn"), True, ValueError, "wdec"),
])
def test_unservable_archs_raise_at_construction(blocks, encoder, error,
                                                match):
    """An unknown block kind raises NotImplementedError naming it; as the
    reference's check_servable: ``enc_attn`` in a decoder pattern (it has
    no serving cache) and an encoder arch without ``wdec`` blocks to take
    its K/V raise ValueError."""
    arch = ArchConfig(name="mixed", family="hybrid", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                      pattern=(Segment(blocks, 1),), dtype="float32",
                      param_dtype="float32", n_img_tokens=8,
                      encoder=EncoderSpec(2, 8, 128) if encoder else None)
    with pytest.raises(error, match=match):
        ContinuousBatchingEngine(arch, {}, device="cpu", slots=2)


def test_matches_jax_engine_on_mla_config():
    """deepseek's shape (TINY_MLA: latent pools, MoE): the port's engine
    and the JAX engine emit the same greedy tokens, logprobs to 1e-5 and
    the same preemption count under chunked prefill and forced preemption
    (the re-prefill rewrites the latent rows); every pool is a block pool,
    so no slot-state kind is reported."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSamplingParams

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, TINY_MLA.vocab, size=n).astype(np.int32)
               for n in (9, 5, 13, 7)]
    kw = dict(slots=2, max_len=32, block_size=4, num_blocks=7,
              prefill_chunk=5)
    jeng = JaxEngine(TINY_MLA, jax_params(TINY_MLA), make_host_mesh(), **kw)
    want = jeng.generate([
        JaxRequest(id=i, prompt=p, max_new_tokens=8,
                   sampling=JaxSamplingParams(logprobs=True))
        for i, p in enumerate(prompts)])
    teng = _engine(TINY_MLA, **kw)
    got = teng.generate([Request(id=i, prompt=p, max_new_tokens=8,
                                 sampling=SamplingParams(logprobs=True))
                         for i, p in enumerate(prompts)])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
    assert teng.cache.stats()["slot_state_kinds"] == []
    assert teng.cache.pool_bytes == 2 * 7 * 4 * (16 + 8) * 4   # 2 layers


def test_prefill_serves_oldest_request_first():
    eng = _engine(TINY, slots=2, max_len=64, block_size=4, prefill_chunk=2)
    older = Request(id=0, prompt=np.arange(1, 9, dtype=np.int32))
    newer = Request(id=1, prompt=np.arange(1, 9, dtype=np.int32))
    eng.submit(older)
    eng.submit(newer)
    eng._admit()
    eng.slots[0], eng.slots[1] = eng.slots[1], eng.slots[0]
    eng._prefill_chunk()
    assert eng.slots[1].prefill_pos == 2      # older advanced
    assert eng.slots[0].prefill_pos == 0      # newer waits


# ---------------------------------------------------------------------------
# requests with frontends, gates opened: against the JAX engine
# ---------------------------------------------------------------------------

def _serve_with_frontends(arch, seed):
    """Four requests, each with its own frontend (gates opened), served by
    the JAX engine and the port's under chunked prefill and forced
    preemption -> (JAX engine, its outputs, port engine, its outputs,
    encoder runs, cross-K/V scatters of the port's)."""
    from repro.launch.mesh import make_host_mesh
    from repro.serving import ContinuousBatchingEngine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, arch.vocab, size=n).astype(np.int32)
               for n in (9, 5, 13, 7)]
    fes = frontend(arch, len(prompts), seed)
    kw = dict(slots=2, max_len=32, block_size=4, num_blocks=7,
              prefill_chunk=5)
    jeng = JaxEngine(arch, jax_params(arch, open_gates=True),
                     make_host_mesh(), **kw)
    want = jeng.generate([
        JaxRequest(id=i, prompt=p, max_new_tokens=8, frontend=fes[i:i + 1],
                   sampling=JaxSamplingParams(logprobs=True))
        for i, p in enumerate(prompts)])
    teng = _engine(arch, open_gates=True, **kw)
    calls = {"encode": 0, "scatter": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    with mock.patch.object(TT, "encode_frontend",
                           counting("encode", TT.encode_frontend)), \
            mock.patch.object(TT, "_scatter_cross_kv",
                              counting("scatter", TT._scatter_cross_kv)):
        got = teng.generate([Request(id=i, prompt=p, max_new_tokens=8,
                                     frontend=fes[i:i + 1],
                                     sampling=SamplingParams(logprobs=True))
                             for i, p in enumerate(prompts)])
    return jeng, want, teng, got, calls


@pytest.mark.parametrize("arch", [TINY_CROSS, TINY_ENCDEC],
                         ids=["cross", "encdec"])
def test_matches_jax_engine_with_frontends(arch):
    """llama-vision's shape (TINY_CROSS: gated cross attention over slot
    rows of the patch embeddings' K/V) and whisper's (TINY_ENCDEC: the
    encoder's K/V in slot rows, sinusoidal positions per row): the port's
    engine and the JAX engine emit the same greedy tokens, logprobs to
    1e-5 and the same preemption count under chunked prefill and forced
    preemption, each request with its own frontend and the gates opened.
    Every admission — re-admissions after preemption included — writes
    the slot's rows once (one cross-K/V scatter for each block of the
    pattern's segment), and whisper's encoder runs once an admission and
    never in a step."""
    jeng, want, teng, got, calls = _serve_with_frontends(arch, 5)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
    assert teng.metrics.preemptions == jeng.metrics.preemptions > 0
    admissions = len(got) + teng.metrics.preemptions
    assert calls["scatter"] == admissions
    assert calls["encode"] == (admissions if arch.encoder else 0)
    assert teng.cache.allocator.num_used == 0
    kinds = teng.cache.stats()["slot_state_kinds"]
    assert kinds == (["wdec"] if arch.encoder else ["cross_attn"])
    # k and v, 2 applications, fp32: slot rows (slots + 1, T) and the
    # paged self-attention pool (7 blocks of 4), n_kv_heads of 16 each
    T = arch.encoder.seq_len if arch.encoder else arch.n_img_tokens
    per_token = 2 * 2 * arch.n_kv_heads * 16 * 4
    assert teng.cache.pool_bytes == per_token * (3 * T + 7 * 4)


@pytest.mark.parametrize("arch", [TINY_CROSS, TINY_ENCDEC],
                         ids=["cross", "encdec"])
def test_admission_writes_the_frontend_rows_the_decoder_reads(arch):
    """Admission writes the slot's rows once: they equal the direct
    projection of the request's frontend (vision) or of the encoder's
    output (whisper) through layer 0's cross wk; and the decoder reads
    them: with the gates opened, the logits of a prefill on the admitted
    pools move by more than 0.1 against the same prompt admitted without
    a frontend (zeroed rows), as the reference's tests hold it."""
    from repro_torch.models import blocks as TB
    from repro_torch.models import layers as TL
    from repro_torch.runtime import steps as TST
    tarch = port_arch(arch)
    params = torch_params(arch, open_gates=True)
    fe = frontend(arch, 1, 7)
    prompt = np.arange(1, 7, dtype=np.int32)
    prefill = TST.make_paged_prefill_step(tarch)

    def logits_after_admit(f):
        eng = _engine(arch, open_gates=True, slots=2, max_len=32,
                      block_size=4, prefill_chunk=8)
        eng.submit(Request(id=0, prompt=prompt.copy(), max_new_tokens=4,
                           frontend=f))
        eng._admit()
        chunk = np.zeros((1, 8), np.int64)
        chunk[0, :len(prompt)] = prompt
        logits, _ = prefill(eng.params, eng.cache.pools,
                            torch.from_numpy(chunk), torch.tensor([0]),
                            torch.from_numpy(eng.cache.table_array([0])),
                            torch.tensor([len(prompt)]), torch.tensor([0]))
        return eng, logits
    eng, with_fe = logits_after_admit(fe)
    key, attn = ("b0", "xattn") if arch.encoder else ("b1", "attn")
    src = (TT.encode_frontend(params, tarch, torch.from_numpy(fe))[0]
           if arch.encoder else torch.from_numpy(fe[0]))
    pool = eng.cache.pools[0][key]
    cfg = TB.cross_cfg_for(tarch, "wdec" if arch.encoder else "cross_attn")
    w = {k: v[0] for k, v in params["segments"][0][key][attn]["wk"].items()}
    k_ref = TL.dense(w, src).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
    rows = (pool["cross"] if arch.encoder else pool)["k"][0, 0]
    torch.testing.assert_close(rows, k_ref, rtol=1e-6, atol=1e-6)
    _, text_only = logits_after_admit(None)
    assert float((with_fe - text_only).abs().max()) > 0.1

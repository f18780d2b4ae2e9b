"""The port's RNG and sampler (``repro_torch.serving.threefry``,
``repro_torch.serving.sampling``) against the live JAX code.

The reference draws a stochastic row's noise as ``jax.random.gumbel(
jax.random.fold_in(jax.random.PRNGKey(seed), position), (vocab,),
float32)`` under the flag value the reference engine runs with, which on
this jax is ``jax_threefry_partitionable=True``; ``test_the_flag_the_port_
follows`` fails loudly if that changes, rather than comparing two schemes.
The JAX sampler is never wrapped in ``threefry_partitionable(False)``.

Tolerances: the uint32 bits and the uniforms are equal exactly; the Gumbel
noise ``-log(-log(u))`` goes through two float32 logs whose last bits torch
and XLA round differently (the inner one by at most 1 ulp), which the
outer log turns into an absolute error of a few ulp of 1.0 where the noise
is near 0: it is held within 2 ulp of max(|g|, 1).  The masks are equal
exactly; the sampler's tokens are equal and its logprobs within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as JS
from repro_torch.serving import sampling as TS
from repro_torch.serving import threefry as TF

SEEDS = (0, 1, 12345, 2 ** 32 - 1)
POSITIONS = (0, 1, 511, 2 ** 31 - 1)
PAIRS = [(s, p) for s in SEEDS for p in POSITIONS]


def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.uint32(pos))


def _port_keys():
    return TF.fold_in(TF.prng_key(torch.tensor([s for s, _ in PAIRS])),
                      torch.tensor([p for _, p in PAIRS]))


def test_the_flag_the_port_follows():
    """The port reproduces the partitionable threefry stream and the "low"
    Gumbel mode, the reference engine's defaults on this jax."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False


@pytest.mark.parametrize("vocab", [300, 4096])
def test_bits_and_uniforms_equal_jax_exactly(vocab):
    """``vocab`` 4096 stands for a slice of qwen3-8b's 151,936: the counter
    of column i is (0, i) whatever the row's length."""
    keys = _port_keys()
    bits = TF.random_bits(keys, vocab).numpy()
    u = TF.uniform(keys, vocab, TF.TINY).numpy()
    for i, (s, p) in enumerate(PAIRS):
        key = _jax_key(s, p)
        want = np.asarray(jax.random.bits(key, (vocab,)))
        np.testing.assert_array_equal(bits[i], want.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(
            key, (vocab,), jnp.float32, minval=TF.TINY, maxval=1.0))
        np.testing.assert_array_equal(u[i], want_u)


def test_fold_in_equals_jax_key_data():
    keys = _port_keys()
    for i, (s, p) in enumerate(PAIRS):
        want = np.asarray(_jax_key(s, p)).astype(np.int64)
        assert [int(keys[0][i]), int(keys[1][i])] == list(want)


@pytest.mark.parametrize("vocab", [300, 4096])
def test_gumbel_within_two_ulp_of_jax(vocab):
    g = TF.gumbel(torch.tensor([s for s, _ in PAIRS]),
                  torch.tensor([p for _, p in PAIRS]), vocab).numpy()
    for i, (s, p) in enumerate(PAIRS):
        want = np.asarray(jax.random.gumbel(_jax_key(s, p), (vocab,),
                                            jnp.float32))
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert np.all(np.abs(g[i].astype(np.float64) - want) <= 2 * ulp), \
            (s, p)


def _logits(rng, B=6, V=300):
    """Seeded logits with planted ties: row 0 ties three values at the 3rd
    largest (top_k 3 keeps the tie), row 1 ties at the 50th, row 2 holds
    -inf entries, row 3 plants two equal maxima that carry half the mass
    (a top-p threshold tie), the rest are plain."""
    lg = rng.normal(0, 3, size=(B, V)).astype(np.float32)
    top = lg[0].max()
    lg[0, [10, 20, 30]] = top + 1
    order = np.argsort(-lg[1])
    lg[1, order[48:52]] = lg[1, order[49]]
    lg[2, ::7] = -np.inf
    lg[3, :] = rng.normal(0, 0.1, size=V)
    lg[3, [5, 6]] = 8.0
    return lg


@pytest.mark.parametrize("k", [0, 1, 3, 50, 299, 300])
def test_top_k_mask_equals_jax(k):
    lg = _logits(np.random.default_rng(0))
    want = np.asarray(JS.apply_top_k(jnp.asarray(lg),
                                     jnp.full((len(lg),), k, jnp.int32)))
    got = TS.apply_top_k(torch.from_numpy(lg),
                         torch.full((len(lg),), k)).numpy()
    np.testing.assert_array_equal(got, want)


def _top_p_both(p, k):
    lg = _logits(np.random.default_rng(1))
    lg = np.array(JS.apply_top_k(jnp.asarray(lg),
                                 jnp.full((len(lg),), k, jnp.int32)))
    want = np.asarray(JS.apply_top_p(jnp.asarray(lg),
                                     jnp.full((len(lg),), p, jnp.float32)))
    got = TS.apply_top_p(torch.from_numpy(lg),
                         torch.full((len(lg),), p)).numpy()
    return lg, want, got


@pytest.mark.parametrize("p", [0.05, 0.3, 0.5, 0.9])
@pytest.mark.parametrize("k", [0, 50])
def test_top_p_mask_equals_jax(p, k):
    _, want, got = _top_p_both(p, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [0, 50])
def test_top_p_at_one_differs_only_in_the_rounding_tail(k):
    """At top_p = 1.0 the reference's mask is not the identity: a tail
    token is dropped where the float32 mass before it rounds to 1.0, and
    which ones do depends on the last bits of the softmax (XLA's exp and
    torch's differ by an ulp) and of the cumulative sum (XLA's CPU cumsum
    adds in float32, one element at a time; torch's CPU cumsum adds in
    float64).  So the two masks are held equal on every token whose mass
    before it, in float64, is below 1 - 2**-20; the tokens either drops
    lie past that, together under 2**-20 of the row's mass."""
    lg, want, got = _top_p_both(1.0, k)
    probs = torch.softmax(torch.from_numpy(lg).double(), -1).numpy()
    order = np.argsort(-probs, axis=-1, kind="stable")
    desc = np.take_along_axis(probs, order, -1)
    before = np.empty_like(probs)
    np.put_along_axis(before, order, np.cumsum(desc, -1) - desc, -1)
    head = before < 1 - 2.0 ** -20
    np.testing.assert_array_equal(got[head], want[head])
    dropped = ~np.isfinite(got) | ~np.isfinite(want)
    assert np.all(np.where(dropped & ~head, probs, 0).sum(-1) < 2.0 ** -20)


def _mixed_rows(rng, B):
    temp = rng.choice([0.0, 0.3, 0.7, 1.0, 1.5], size=B).astype(np.float32)
    temp[0], temp[1] = 0.0, 1.5                # a greedy and a hot row
    top_k = rng.choice([0, 1, 50], size=B).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.3], size=B).astype(np.float32)
    seeds = rng.choice(np.asarray(SEEDS, np.uint32), size=B)
    pos = rng.choice(np.asarray(POSITIONS, np.int64), size=B)
    return temp, top_k, top_p, seeds, pos


@pytest.mark.parametrize("seed", range(4))
def test_make_sampler_equals_jax_on_mixed_batches(seed):
    """Greedy and stochastic rows in one batch, top_k 0 / 1 / 50, top_p 1.0
    / 0.9 / 0.3, temperatures 0.3-1.5, a padded vocab (300 of 512) and the
    planted ties: equal tokens, logprobs within 1e-5."""
    rng = np.random.default_rng(seed)
    lg = np.concatenate([_logits(rng), _logits(rng)])
    lg = np.pad(lg, ((0, 0), (0, 212)), constant_values=9.0)  # padding cols
    temp, top_k, top_p, seeds, pos = _mixed_rows(rng, len(lg))
    jt, jl = JS.make_sampler(300)(
        jnp.asarray(lg), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(seeds),
        jnp.asarray(pos.astype(np.uint32)))
    tt, tl = TS.make_sampler(300)(torch.from_numpy(lg), temp, top_k, top_p,
                                  seeds, torch.from_numpy(pos))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def test_greedy_rows_are_bit_exact_in_either_branch():
    """A greedy row gives the same token and the same logprob bits whether
    its batch is all greedy (the host-chosen greedy branch) or mixed."""
    rng = np.random.default_rng(7)
    lg = torch.from_numpy(_logits(rng))
    z = np.zeros(len(lg), np.float32)
    sample = TS.make_sampler(300)
    pos = torch.arange(len(lg))
    t0, l0 = sample(lg, None, None, None, None, pos)
    temp = z.copy()
    temp[1] = 0.9
    t1, l1 = sample(lg, temp, z.astype(np.int32), z + 1,
                    z.astype(np.uint32), pos)
    keep = np.arange(len(lg)) != 1
    assert torch.equal(t0[keep], t1[keep])
    assert torch.equal(l0[keep], l1[keep])


def test_sampler_refuses_rows_it_cannot_honour():
    lg = torch.zeros((2, 300))
    hot = np.asarray([0.0, 0.8], np.float32)
    sample = TS.make_sampler(300)
    with pytest.raises(ValueError, match="seeds"):
        sample(lg, hot, None, None, None, torch.arange(2))
    with pytest.raises(ValueError, match="exceeds the vocabulary"):
        sample(lg, hot, np.asarray([0, 301]), np.ones(2, np.float32),
               np.zeros(2, np.uint32), torch.arange(2))

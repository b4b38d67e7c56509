"""The port's stochastic sampler against the JAX package's on the CPU.

The randomness sources differ on purpose (a counter-based hash in the
port, threefry in the reference), so the port is held to the reference:

* exactly, where no randomness is involved — the top-k / top-p kept sets
  (``_filter_logits_rows``) on tied integer logits over [B, V] and
  [N, C, V], and greedy rows of ``sample_tokens_rows`` and
  ``verify_draft_rows``, bit for bit;
* in distribution otherwise — each side's draws pass a chi-square test
  against the exact filtered softmax (computed in float64 from the kept
  set), the two sides' empirical distributions are within a stated total
  variation of each other, and stochastic verification accepts a draft
  token at the rate p(d) within a binomial bound.

Draws are keyed by (seed, counter); every seed is fixed, so each test is
deterministic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from scipy.stats import chi2

from repro.serving import sampling as js
from repro_torch.serving import sampling as ts

N_DRAWS = 20_000
# chi-square: the statistic's 1 - 1e-6 quantile (a correct sampler fails
# one such test in a million); TV: two samples of N_DRAWS from the same
# distribution over <= 12 outcomes differ by ~0.01 in expectation
CHI2_Q = 1 - 1e-6
TV_BOUND = 0.03


def _kept(x):
    return np.asarray(x) > ts.NEG_INF / 2


def _filter_both(lg, k, p):
    lead = (lg.shape[0],) + (1,) * (lg.ndim - 1)
    want = js._filter_logits_rows(jnp.asarray(lg),
                                  jnp.asarray(k).reshape(lead),
                                  jnp.asarray(p).reshape(lead))
    got = ts._filter_logits_rows(torch.from_numpy(lg),
                                 torch.from_numpy(k).reshape(lead),
                                 torch.from_numpy(p).reshape(lead))
    return np.asarray(want), got.numpy()


@settings(derandomize=True, database=None, max_examples=120, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), window=st.booleans(),
       V=st.sampled_from([2, 7, 33]))
def test_kept_sets_equal_the_reference_with_ties(seed, window, V):
    """Integer logits in [-3, 3] tie often: the kept set (the first k ranks
    of a stable descending sort, then the minimal nucleus prefix) equals
    the reference's exactly, on [B, V] and on verify windows [N, C, V],
    and kept values are the scaled logits themselves.  (A few vocabulary
    widths keep the reference's per-shape compiles few.)"""
    rng = np.random.default_rng(seed)
    shape = (3, 4, V) if window else (4, V)
    lg = rng.integers(-3, 4, shape).astype(np.float32)
    k = rng.integers(0, V + 3, shape[0]).astype(np.int32)
    p = rng.choice([0.0, 0.25, 0.5, 0.77, 0.9, 1.0],
                   shape[0]).astype(np.float32)
    want, got = _filter_both(lg, k, p)
    np.testing.assert_array_equal(_kept(got), _kept(want))
    np.testing.assert_array_equal(got[_kept(got)], lg[_kept(got)])


def test_scalar_filter_and_sampler_match_the_rows_version():
    """``_filter_logits`` with one (k, p) pair is the per-row filter with
    that pair in every row (the reference's two functions agree the same
    way), and ``sample_tokens`` needs a key unless greedy."""
    rng = np.random.default_rng(1)
    lg = rng.integers(-3, 4, (5, 17)).astype(np.float32)
    for k, p in ((0, 0.0), (4, 0.0), (0, 0.6), (6, 0.8), (40, 1.0)):
        want = np.asarray(js._filter_logits(jnp.asarray(lg), k, p))
        got = ts._filter_logits(torch.from_numpy(lg), k, p).numpy()
        np.testing.assert_array_equal(_kept(got), _kept(want))
    t = torch.from_numpy(lg)
    assert ts.sample_tokens(t).tolist() == np.argmax(lg, -1).tolist()
    with pytest.raises(ValueError, match="requires a"):
        ts.sample_tokens(t, greedy=False)
    a = ts.sample_tokens(t, greedy=False, temperature=0.9, top_k=5, key=7)
    b = ts.sample_tokens(t, greedy=False, temperature=0.9, top_k=5, key=7)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert _kept(ts._filter_logits(t, 5, 0.0).numpy())[
        np.arange(5), a.numpy()].all()


def test_hash_stays_in_32_bit_lanes():
    """Keys and bits never leave [0, 2^32) — every multiplier is below
    2^31, so no int64 product overflows even at the largest seeds and
    counters — and the uniforms lie strictly inside (0, 1)."""
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 12345])
    counters = torch.tensor([0, 2 ** 31 - 1, 7, 2 ** 32 - 1, 1])
    keys = ts.row_keys(seeds, counters)
    bits = ts.random_bits(keys, 3, (2, 1000))
    for x in (keys, bits):
        assert x.dtype == torch.int64
        assert int(x.min()) >= 0 and int(x.max()) < 2 ** 32
    u = ts.uniform(keys, 0, (5000,))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert torch.isfinite(ts.gumbel(keys, 0, (5000,))).all()
    # a pure function of (seed, counter): the same key wherever it is made
    assert torch.equal(ts.row_keys(seeds[2:3], counters[2:3]), keys[2:3])
    assert len(set(keys.tolist())) == len(keys)


def test_greedy_rows_are_bit_identical():
    """In a mixed batch, greedy rows of ``sample_tokens_rows`` are the
    argmax and greedy rows of ``verify_draft_rows`` equal greedy
    ``verify_draft`` — on both packages, bit for bit."""
    rng = np.random.default_rng(2)
    N, C, V = 6, 5, 11
    lg = rng.integers(0, 4, (N, C, V)).astype(np.float32)
    draft = np.argmax(lg[:, :C - 1], -1).astype(np.int32)
    draft[rng.random((N, C - 1)) < 0.3] = 1
    dlen = rng.integers(0, C, N).astype(np.int32)
    temps = np.array([0, 0.8, 0, 1.2, 0, 0.5], np.float32)
    k = np.array([0, 3, 0, 0, 2, 5], np.int32)
    p = np.array([0, 0, 0.5, 0.9, 0, 0], np.float32)
    greedy = temps <= 0
    keys = ts.row_keys(torch.arange(N), torch.arange(N) * 3)
    t = lambda a: torch.from_numpy(a)              # noqa: E731
    got = ts.sample_tokens_rows(t(lg[:, 0]), t(temps), t(k), t(p), keys)
    assert got.numpy()[greedy].tolist() == np.argmax(lg[greedy, 0],
                                                     -1).tolist()
    toks, n = ts.verify_draft_rows(t(lg), t(draft), t(dlen), t(temps), t(k),
                                   t(p), keys)
    g_toks, g_n = ts.verify_draft(t(lg), t(draft), t(dlen))
    j_toks, j_n = js.verify_draft(jnp.asarray(lg), jnp.asarray(draft),
                                  jnp.asarray(dlen), greedy=True)
    np.testing.assert_array_equal(toks.numpy()[greedy], g_toks.numpy()[greedy])
    np.testing.assert_array_equal(n.numpy()[greedy], g_n.numpy()[greedy])
    np.testing.assert_array_equal(g_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(j_n))
    jk = js.row_keys(jnp.arange(N), jnp.arange(N) * 3)
    jt, jn = js.verify_draft_rows(jnp.asarray(lg), jnp.asarray(draft),
                                  jnp.asarray(dlen), jnp.asarray(temps),
                                  jnp.asarray(k), jnp.asarray(p), jk)
    np.testing.assert_array_equal(np.asarray(jt)[greedy],
                                  toks.numpy()[greedy])
    # every row emits between 1 and draft_len + 1 tokens
    assert ((n.numpy() >= 1) & (n.numpy() <= dlen + 1)).all()


def _exact_probs(row, temp, k, p):
    """The filtered softmax in float64 over the reference's kept set."""
    filt = np.asarray(js._filter_logits_rows(
        jnp.asarray(row[None] / max(temp, 1e-6)), jnp.asarray([[k]]),
        jnp.asarray([[p]], jnp.float32)))[0]
    kept = _kept(filt)
    z = row.astype(np.float64) / temp
    e = np.where(kept, np.exp(z - z[kept].max()), 0.0)
    return e / e.sum(), kept


def _chi2_ok(counts, probs, kept):
    n = counts.sum()
    stat = (((counts[kept] - n * probs[kept]) ** 2) / (n * probs[kept])).sum()
    return stat, chi2.ppf(CHI2_Q, int(kept.sum()) - 1)


@pytest.mark.parametrize("temp,k,p", [(1.0, 0, 0.0), (0.8, 5, 0.0),
                                      (0.7, 0, 0.9), (1.3, 6, 0.95)])
def test_stochastic_draws_match_the_filtered_distribution(temp, k, p):
    """N_DRAWS draws of one 12-entry row (one seed, counters 0..N-1) on
    each package: every draw in the kept set, each side's counts within
    chi-square of the exact filtered probabilities, and the two sides
    within TV_BOUND of each other."""
    row = np.array([1.0, 2.5, 0.3, 2.5, -1.0, 1.8, 0.0, 2.2, -0.5, 1.1,
                    0.9, 3.0], np.float32)
    V = row.size
    probs, kept = _exact_probs(row, temp, k, p)
    lg = np.broadcast_to(row, (N_DRAWS, V)).copy()
    par = lambda v, d: np.full((N_DRAWS,), v, d)   # noqa: E731
    ours = ts.sample_tokens_rows(
        torch.from_numpy(lg), torch.from_numpy(par(temp, np.float32)),
        torch.from_numpy(par(k, np.int32)),
        torch.from_numpy(par(p, np.float32)),
        ts.row_keys(torch.full((N_DRAWS,), 11), torch.arange(N_DRAWS)))
    theirs = js.sample_tokens_rows(
        jnp.asarray(lg), jnp.asarray(par(temp, np.float32)),
        jnp.asarray(par(k, np.int32)), jnp.asarray(par(p, np.float32)),
        js.row_keys(jnp.full((N_DRAWS,), 11), jnp.arange(N_DRAWS)))
    counts = []
    for draws in (ours.numpy(), np.asarray(theirs)):
        assert kept[draws].all()
        c = np.bincount(draws, minlength=V).astype(np.float64)
        stat, bound = _chi2_ok(c, probs, kept)
        assert stat < bound, (stat, bound)
        counts.append(c / N_DRAWS)
    assert 0.5 * np.abs(counts[0] - counts[1]).sum() < TV_BOUND


def test_stochastic_verification_accepts_at_rate_p():
    """One-draft windows, N_DRAWS rows (counters 0..N-1): the draft token
    is accepted at the rate p(d) of the filtered target distribution
    within five binomial standard deviations, on both packages; a
    rejection never re-emits the draft, and the correction and the bonus
    lie in the kept set."""
    row = np.array([0.5, 2.0, 1.0, -0.3, 1.7, 0.1], np.float32)
    temp, k, p = 0.9, 4, 0.0
    probs, kept = _exact_probs(row, temp, k, p)
    d = 4
    lg = np.broadcast_to(row, (N_DRAWS, 2, row.size)).copy()
    draft = np.full((N_DRAWS, 1), d, np.int32)
    dlen = np.ones((N_DRAWS,), np.int32)
    par = lambda v, t: np.full((N_DRAWS,), v, t)   # noqa: E731
    ours = ts.verify_draft_rows(
        torch.from_numpy(lg), torch.from_numpy(draft),
        torch.from_numpy(dlen), torch.from_numpy(par(temp, np.float32)),
        torch.from_numpy(par(k, np.int32)),
        torch.from_numpy(par(p, np.float32)),
        ts.row_keys(torch.full((N_DRAWS,), 5), torch.arange(N_DRAWS)))
    theirs = js.verify_draft_rows(
        jnp.asarray(lg), jnp.asarray(draft), jnp.asarray(dlen),
        jnp.asarray(par(temp, np.float32)), jnp.asarray(par(k, np.int32)),
        jnp.asarray(par(p, np.float32)),
        js.row_keys(jnp.full((N_DRAWS,), 5), jnp.arange(N_DRAWS)))
    sd = np.sqrt(probs[d] * (1 - probs[d]) / N_DRAWS)
    for toks, n in ((ours[0].numpy(), ours[1].numpy()),
                    (np.asarray(theirs[0]), np.asarray(theirs[1]))):
        assert ((n >= 1) & (n <= 2)).all()
        rate = (n == 2).mean()
        assert abs(rate - probs[d]) < 5 * sd, (rate, probs[d])
        rejected = n == 1
        assert (toks[rejected, 0] != d).all()
        assert kept[toks[rejected, 0]].all() and kept[toks[~rejected, 1]
                                                      ].all()
        assert (toks[~rejected, 0] == d).all()
    # without its randomness source, stochastic verification raises
    with pytest.raises(ValueError, match="requires a"):
        ts.verify_draft(torch.from_numpy(lg[:2]), torch.from_numpy(draft[:2]),
                        torch.from_numpy(dlen[:2]), greedy=False)


@pytest.mark.parametrize("K", [1, 3, 4])
def test_stochastic_verification_emits_within_bounds(K):
    """Random windows of k drafts at every draft length: n_emitted in
    [1, draft_len + 1], the accepted prefix is the draft's own tokens, and
    every emitted token lies in its position's kept set; the scalar
    ``verify_draft`` with a key is the rows version with that key folded
    per row."""
    rng = np.random.default_rng(K)
    N, V = 64, 9
    lg = rng.normal(size=(N, K + 1, V)).astype(np.float32)
    draft = rng.integers(0, V, (N, K)).astype(np.int32)
    dlen = rng.integers(0, K + 1, N).astype(np.int32)
    t = torch.from_numpy
    toks, n = ts.verify_draft(t(lg), t(draft), t(dlen), greedy=False,
                              temperature=0.8, top_k=5, key=123)
    toks, n = toks.numpy(), n.numpy()
    assert ((n >= 1) & (n <= dlen + 1)).all()
    kept = _kept(ts._filter_logits(t(lg) / 0.8, 5, 0.0).numpy())
    for i in range(N):
        acc = n[i] - 1
        assert (toks[i, :acc] == draft[i, :acc]).all()
        assert kept[i, acc, toks[i, acc]]
    keys = ts.fold_in(torch.tensor(123), torch.arange(N))
    toks2, n2 = ts.verify_draft_rows(
        t(lg), t(draft), t(dlen), torch.full((N,), 0.8),
        torch.full((N,), 5), torch.zeros(N), keys)
    np.testing.assert_array_equal(toks2.numpy(), toks)
    np.testing.assert_array_equal(n2.numpy(), n)

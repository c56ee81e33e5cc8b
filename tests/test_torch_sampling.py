"""Port sampling against the JAX package's ``repro.serving.sampling`` and
``jax.random`` on the same seeded inputs.

* ``token_key`` and the raw bits and uniforms under it are BIT-EQUAL to
  ``jax.random.fold_in(PRNGKey(seed), i)``, ``jax.random.bits`` and the
  uniform of ``jax.random.gumbel``'s default "low" mode; the Gumbel
  draws themselves differ by at most GUMBEL_ULPS ulps of max(1, |g|)
  (only ``log`` rounds differently; near g = 0 the two logs cancel, so
  the ulp is taken of 1 there).
* ``categorical(i, logits)`` draws ``jax.random.categorical(PRNGKey(i),
  logits)``'s tokens (the legacy loop's sampling).
* ``filter_rows`` masks equal ``_filter_row``'s, tied logits included.
  A token whose top-p quantity (the mass before it) lies within
  TOP_P_ULPS float32 ulps of p could fall on either side of the
  boundary (XLA and torch sum in different orders): such tokens are
  counted and printed, and where the nucleus cuts (p < 1) none may
  occur on these inputs.  At p = 1 (the nucleus off) JAX still drops
  the tail whose prior mass has rounded up to 1.0; those tokens are
  printed too, their mass is asserted below TOP_P_ULPS ulps of 1, and
  only they may differ.
* ``sample_tokens`` tokens equal JAX's; a difference is accepted only
  where the top two perturbed scores lie within NEAR_TIE of each other
  (printed; none expected).
* A row's token does not depend on the batch around it.
* Through the engines (tests/test_torch_sampling_engine.py): sampled
  tokens equal the JAX engine's, a stop token ends a sampled request at
  its first occurrence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as js
from repro_torch.serving import SamplingParams, sampling as ts

torch.set_num_threads(1)

GUMBEL_ULPS = 4        # |gumbel_port - gumbel_jax| <= this many ulps
                       # of max(1, |gumbel|)
TOP_P_ULPS = 8         # a top-p boundary this close is a near-tie
NEAR_TIE = 1e-5        # perturbed scores closer than this may swap
TINY = float(np.finfo(np.float32).tiny)

KEYS = [(0, 0), (1, 3), (7, 17), (1000, 500), (2 ** 31 + 5, 1023),
        (2 ** 32 - 1, 99999), (123456789, 2 ** 31 - 1)]


def _key(seed, index):
    return jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                              np.int32(index))


def _port_key(seed, index):
    return ts.token_key(torch.tensor([seed]), torch.tensor([index]))


def test_reference_draws_gumbel_in_low_mode():
    """The port reproduces the "low" mode; it is JAX's default only
    while the high-dynamic-range flag is off."""
    assert not jax.config.jax_high_dynamic_range_gumbel
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed,index", KEYS)
def test_token_key_bits_and_uniforms_bit_equal(seed, index):
    key = _key(seed, index)
    k1, k2 = _port_key(seed, index)
    assert (int(k1[0]), int(k2[0])) == tuple(int(w) for w in np.asarray(key))
    v = 3000
    bits = np.asarray(jax.random.bits(key, (v,), jnp.uint32))
    np.testing.assert_array_equal(ts.random_bits(k1, k2, (v,)).numpy(),
                                  bits.astype(np.int64))
    want = np.asarray(jax.random.uniform(key, (v,), jnp.float32,
                                         minval=TINY, maxval=1.0))
    got = ts.uniform(k1, k2, (v,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    g_want = np.asarray(jax.random.gumbel(key, (v,), jnp.float32))
    g_got = ts.gumbel(k1, k2, (v,)).numpy()
    ulps = np.abs(g_got - g_want) / np.spacing(
        np.maximum(1.0, np.abs(g_want)).astype(np.float32))
    assert ulps.max() <= GUMBEL_ULPS, ulps.max()


@pytest.mark.parametrize("shape", [(3, 500), (1, 32000), (4, 7)])
def test_legacy_categorical_matches_jax(shape):
    logits = np.random.default_rng(shape[1]).standard_normal(shape) \
        .astype(np.float32)
    for i in range(6):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(i),
                                                 jnp.asarray(logits)))
        got = ts.categorical(i, torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)


def _logit_rows(n, v, seed, ties):
    x = np.random.default_rng(seed).standard_normal((n, v)) * 2
    if ties:                    # many exactly equal logits per row
        x = np.round(x * 2) / 2
    return x.astype(np.float32)


def _boundary_tokens(x, top_p):
    """(row, vocab index, prior mass, probability) of every token whose
    top-p quantity (cumulative mass before it) lies within TOP_P_ULPS
    float32 ulps of p, reckoned in float64."""
    out = []
    for r, (row, p) in enumerate(zip(x.astype(np.float64), top_p)):
        order = np.argsort(-row, kind="stable")
        pr = np.exp(row[order] - row.max())
        pr /= pr.sum()
        before = np.cumsum(pr) - pr
        margin = TOP_P_ULPS * float(np.spacing(np.float32(p)))
        near = np.nonzero(np.abs(before - p) < margin)[0]
        out += [(r, int(order[j]), float(before[j]), float(pr[j]))
                for j in near]
    return out


def _check_near_ties(near, top_p):
    """None where the nucleus cuts; at p = 1 the flagged tail's mass is
    below TOP_P_ULPS ulps of 1.  Returns the flagged (row, index)."""
    print(f"top-p boundary near-ties: {len(near)}", near[:20])
    assert not [t for t in near if top_p[t[0]] < 1.0], near
    for r in {t[0] for t in near}:
        assert sum(t[3] for t in near if t[0] == r) \
            < TOP_P_ULPS * float(np.spacing(np.float32(1.0)))
    return {(t[0], t[1]) for t in near}


FILTERS = [(0, 1.0), (5, 1.0), (0, 0.9), (50, 0.95), (1, 0.5), (3, 0.3)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_k,top_p", FILTERS)
def test_filter_rows_masks_equal_jax(top_k, top_p, ties):
    x = _logit_rows(4, 257, 11 + top_k, ties)
    k = np.full(4, top_k, np.int32)
    p = np.full(4, top_p, np.float32)
    flagged = _check_near_ties(_boundary_tokens(x, p), p)
    want = np.asarray(jax.vmap(js._filter_row)(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(p)))
    got = ts.filter_rows(torch.from_numpy(x), torch.from_numpy(k),
                         torch.from_numpy(p)).numpy()
    differ = {(int(r), int(j)) for r, j in zip(*np.nonzero(got != want))}
    print("mask differences:", sorted(differ))
    assert differ <= flagged


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    index = rng.integers(0, 4096, n).astype(np.int32)
    temps = rng.choice([0.0, 0.3, 0.8, 1.0, 1.7], n).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 50], n).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.7], n).astype(np.float32)
    return seeds, index, temps, top_k, top_p


def _near_tie(logits, seeds, index, temps, top_k, top_p, row):
    """Gap between the top two perturbed scores of ``row`` (JAX's)."""
    key = _key(int(seeds[row]), int(index[row]))
    t = max(float(temps[row]), 1e-6)
    f = np.asarray(js._filter_row(jnp.asarray(logits[row] / np.float32(t)),
                                  top_k[row], top_p[row]))
    s = np.sort(f + np.asarray(jax.random.gumbel(key, f.shape)))
    return float(s[-1] - s[-2])


@pytest.mark.parametrize("v", [128, 2048, 32000])
def test_sample_tokens_match_jax(v):
    n = 16
    logits = _logit_rows(n, v, v, ties=False)
    seeds, index, temps, top_k, top_p = _rows(n, v)
    sampled = temps > 0
    _check_near_ties(
        [t for t in _boundary_tokens(
            logits / np.maximum(temps, 1e-6)[:, None], top_p)
         if sampled[t[0]] and (top_k[t[0]] == 0 or
                               t[1] in np.argsort(-logits[t[0]],
                                                  kind="stable")[
                                   :top_k[t[0]]])], top_p)
    want = np.asarray(js.sample_tokens(
        jnp.asarray(logits), jnp.asarray(index), jnp.asarray(seeds),
        jnp.asarray(temps), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = ts.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(index),
        torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(temps),
        torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    diff = np.nonzero(got != want)[0]
    gaps = [(int(r), _near_tie(logits, seeds, index, temps, top_k, top_p, r))
            for r in diff]
    print("token differences (row, top-two gap):", gaps)
    assert all(g < NEAR_TIE for _r, g in gaps), gaps
    assert len(diff) == 0, "a near-tie is accepted, but none is expected"
    # greedy rows are the first-index argmax
    g = temps == 0
    np.testing.assert_array_equal(got[g], np.argmax(logits[g], axis=-1))


def test_sampled_row_does_not_depend_on_its_batch():
    """A row's token is a function of its logits, seed and position: the
    same row alone, in another batch slot, or beside padding rows gives
    the same token."""
    n, v = 8, 2048
    logits = _logit_rows(n, v, 3, ties=False)
    rows = _rows(n, 3)
    t = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
         for a in rows]
    x = torch.from_numpy(logits)
    full = ts.sample_tokens(x, *t)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    shuffled = ts.sample_tokens(x[perm], *[a[perm] for a in t])
    np.testing.assert_array_equal(shuffled.numpy(), full[perm].numpy())
    for r in range(n):
        alone = ts.sample_tokens(x[r:r + 1], *[a[r:r + 1] for a in t])
        assert int(alone[0]) == int(full[r])


def test_greedy_operands_skip_the_draws():
    """``SamplingRows`` of greedy rows hands no operands to the step;
    ``sample_tokens`` without operands is the argmax."""
    class R:
        sampling = SamplingParams(top_k=5, seed=9)
    rows = ts.sampling_rows([R(), R()], 4)
    assert rows.greedy and rows.as_args("cpu") == (None,) * 4
    x = torch.from_numpy(_logit_rows(4, 64, 0, ties=True))
    np.testing.assert_array_equal(ts.sample_tokens(x).numpy(),
                                  np.argmax(x.numpy(), axis=-1))
    R.sampling = SamplingParams(temperature=0.5, seed=2 ** 32 + 7)
    rows = ts.sampling_rows([R()], 2)
    assert not rows.greedy
    assert rows.seeds.tolist() == [7, 0] and rows.temps.tolist() == [0.5, 0]
    assert [a.device.type for a in rows.as_args("cpu")] == ["cpu"] * 4

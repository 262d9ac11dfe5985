"""Token selection of the PyTorch port (``ops/sampling.py``) against the JAX
package, on the CPU.

The same seeded numpy inputs go to both packages. The nucleus is
deterministic and must be JAX's: the bisected threshold within 1e-6 and the
kept set identical, the sort route's drop mask identical (inputs without
ties). The draws cannot be JAX's (its PRNG stream is not reproduced), so
they are held to JAX's nucleus: every draw inside it, and their frequencies
to its renormalized probabilities by a chi-square test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from paligemma_tpu.ops import sampling as jsamp
from paligemma_tpu_torch.ops import sampling as tsamp


def _logits(b, v, seed, scale=2.0):
    return (np.random.RandomState(seed).randn(b, v) * scale).astype(np.float32)


def _probs(b, v, seed, spread=8.0):
    """fp32 probabilities without ties, the same array for both packages:
    a softmax over a shuffled grid of logits ``spread`` wide (neighbours
    differ by spread / v, far above an fp32 ulp)."""
    rng = np.random.RandomState(seed)
    x = np.stack([rng.permutation(v) for _ in range(b)]) * (spread / v)
    p = np.exp(x - x.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    assert all(len(np.unique(row)) == v for row in p)  # no ties
    return p


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("v", [64, 1000, 20000])
def test_nucleus_threshold_matches_jitted_jax(v, top_p):
    probs = _probs(4, v, seed=v)
    t_j = np.asarray(jax.jit(jsamp._nucleus_threshold)(jnp.asarray(probs), top_p))
    t_t = tsamp._nucleus_threshold(torch.from_numpy(probs), top_p).numpy()
    assert t_t.shape == (4, 1) and t_t.dtype == np.float32
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(probs >= t_t, probs >= t_j)  # the same nucleus
    # It is the top-p nucleus: its mass exceeds p.
    assert ((probs * (probs >= t_t)).sum(-1) > top_p).all()


@jax.jit
def _jax_sort_drop(probs, top_p):
    """The drop mask of JAX's ``sample_top_p(method="sort")``
    (paligemma_tpu/ops/sampling.py, its sorted route), unfolded."""
    sort_idx = jnp.argsort(-probs, axis=-1)
    probs_sort = jnp.take_along_axis(probs, sort_idx, axis=-1)
    cumsum = jnp.cumsum(probs_sort, axis=-1)
    return sort_idx, (cumsum - probs_sort) > top_p


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("v", [64, 1000, 20000])
def test_sort_route_drop_mask_matches_jax(v, top_p):
    probs = _probs(3, v, seed=v + 1)
    idx_j, drop_j = map(np.asarray, _jax_sort_drop(jnp.asarray(probs), top_p))
    probs_sort, idx_t, drop_t = tsamp._sort_nucleus(torch.from_numpy(probs), top_p)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(probs_sort.numpy(), np.take_along_axis(probs, idx_j, -1))
    np.testing.assert_array_equal(drop_t.numpy(), drop_j)


# The frequency test: ROWS draws from one V=32 distribution (logits of
# scale 1) at temperature 0.8, top_p 0.9: a nucleus of 17 tokens here, the
# rarest with ~228 expected draws, far above the 5 a chi-square test needs.
# A draw outside JAX's nucleus fails outright; the counts fail if the
# statistic passes the chi-square quantile at 1 - 1e-6 for (nucleus size -
# 1) degrees of freedom (58.3 for 16), which a correct sampler passes but
# once in a million seeds.
ROWS, V_FREQ, P_FAIL = 20000, 32, 1e-6


@pytest.mark.parametrize("method", ["sort", "threshold"])
def test_sample_top_p_draws_follow_jax_nucleus(method):
    temperature, top_p = 0.8, 0.9
    logits = np.repeat(_logits(1, V_FREQ, seed=5, scale=1.0), ROWS, axis=0)
    probs_j = np.asarray(jax.nn.softmax(jnp.asarray(logits[:1]) / jnp.float32(temperature), axis=-1))
    t_j = np.asarray(jax.jit(jsamp._nucleus_threshold)(jnp.asarray(probs_j), top_p))
    kept = np.where(probs_j >= t_j, probs_j, 0.0)[0].astype(np.float64)
    expected = ROWS * kept / kept.sum()
    nucleus = np.flatnonzero(kept)
    assert len(nucleus) == 17 and expected[nucleus].min() > 200

    gen = torch.Generator().manual_seed(0)
    draws = tsamp.sample_top_p(torch.from_numpy(logits), gen, temperature, top_p, method=method)
    assert draws.dtype == torch.int32 and tuple(draws.shape) == (ROWS,)
    counts = np.bincount(draws.numpy(), minlength=V_FREQ)
    assert counts[kept == 0].sum() == 0  # every draw inside JAX's nucleus
    chi2 = float((((counts - expected) ** 2)[nucleus] / expected[nucleus]).sum())
    bound = stats.chi2.ppf(1 - P_FAIL, len(nucleus) - 1)
    assert 58.0 < bound < 58.6
    assert chi2 < bound, (chi2, bound, counts[nucleus], expected[nucleus])
    # The same seed draws the same tokens.
    again = tsamp.sample_top_p(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                               temperature, top_p, method=method)
    assert torch.equal(again, draws)


def test_sample_top_p_auto_takes_the_threshold_above_16384():
    logits = torch.from_numpy(_logits(2, 20000, seed=9))
    for method, v in (("threshold", 20000), ("sort", 1000)):
        want = tsamp.sample_top_p(logits[:, :v], torch.Generator().manual_seed(1), method=method)
        got = tsamp.sample_top_p(logits[:, :v], torch.Generator().manual_seed(1))
        assert torch.equal(got, want)


def test_sample_rows_greedy_rows_are_exact_and_sampled_rows_in_their_nucleus():
    logits = _logits(6, 1000, seed=3)
    temperature = np.array([0.0, 0.8, -1.0, 1.2, 0.0, 0.5], np.float32)
    top_p = np.array([0.9, 0.5, 0.9, 0.99, 0.2, 0.9], np.float32)
    got = tsamp.sample_rows(torch.from_numpy(logits), torch.Generator().manual_seed(2),
                            torch.from_numpy(temperature), torch.from_numpy(top_p)).numpy()
    ref = np.asarray(jsamp.sample_rows(jnp.asarray(logits), jax.random.PRNGKey(0),
                                       jnp.asarray(temperature), jnp.asarray(top_p)))
    greedy_rows = temperature <= 0
    np.testing.assert_array_equal(got[greedy_rows], logits.argmax(-1)[greedy_rows])
    np.testing.assert_array_equal(got[greedy_rows], ref[greedy_rows])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / jnp.maximum(jnp.asarray(temperature), 1e-6)[:, None]))
    t = np.asarray(jax.jit(jsamp._nucleus_threshold)(jnp.asarray(probs), jnp.asarray(top_p)[:, None]))
    for r in np.flatnonzero(~greedy_rows):
        assert probs[r, got[r]] >= t[r, 0]


@pytest.mark.parametrize("temperature", [
    0.0,
    torch.tensor(0.0),
    torch.zeros(3, 1),
    torch.tensor([[0.0], [0.8], [0.0]]),  # per row: rows 0 and 2 greedy
])
def test_select_token_traced_temperature_zero_is_greedy(temperature):
    logits = torch.from_numpy(_logits(3, 500, seed=4))
    greedy = logits.argmax(-1).to(torch.int32)
    got = tsamp.select_token_traced(logits, torch.Generator().manual_seed(0), True, temperature, 0.9)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3,)
    rows = [0, 2] if isinstance(temperature, torch.Tensor) and temperature.numel() == 3 else [0, 1, 2]
    assert torch.equal(got[rows], greedy[rows])
    assert torch.equal(tsamp.select_token_traced(logits, None, False, 0.8, 0.9), greedy)
    assert torch.equal(tsamp.select_token(logits, None, True, 0.0, 0.9), greedy)

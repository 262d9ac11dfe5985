"""Speculative decoding of the PyTorch port against JAX's, on the CPU.

Tiny config, fp32, the same weights in both packages (``from_jax_params``),
inputs made from numpy seeds. The drafters must propose JAX's tokens
exactly; the decode attention's verify shape (T queries, query i seeing one
position more than query i - 1) must give JAX's threshold-masked
``gqa_attention`` within 1e-5, as must ``verify_step``'s logits; and
``generate_spec`` must give JAX's tokens and acceptance counts exactly, and
the port's plain greedy stream. Sampled streams are held to plain sampling
by their top-token marginals (as ``tests/test_speculative.py`` does).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu import generation as jgen
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.ops.attention import MASK_VALUE, gqa_attention
import paligemma_tpu_torch
from paligemma_tpu_torch import generation as tgen
from paligemma_tpu_torch import quantization
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.utils.convert import from_jax_params

CACHES = {"float": (jnp.float32, None), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def setup():
    """The JAX test's tiny model and request maker, and the port's copy.
    The final norm's scale (1 + w) is redrawn as N(0, 1): with the seeded
    weights a greedy stream repeats one token and every draft is accepted;
    with the redrawn scale the streams change token, and drafts are
    accepted and rejected."""
    cfg_j = j_tiny_config()
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    norm = params["llm"]["final_norm"]
    params["llm"]["final_norm"] = jnp.asarray(np.random.RandomState(3).randn(*norm.shape) - 1, jnp.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            paligemma_tpu_torch.tiny_config(), device="cpu")
    n_img, size = cfg_j.vision_config.num_image_tokens, cfg_j.vision_config.image_size

    def mk(seed, text=None):
        r = np.random.RandomState(seed)
        text = r.randint(4, 200, size=12) if text is None else np.asarray(text)
        ids = np.concatenate([np.full(n_img, cfg_j.image_token_index), text])[None].astype(np.int32)
        return ids, r.randn(1, 3, size, size).astype(np.float32)

    return cfg_j, params, model, mk


# ---------------------------------------------------------------------------
# The drafters
# ---------------------------------------------------------------------------


def _rows(seed, length=48, hi=9):
    """A repetitive id buffer (few distinct ids), so that n-grams recur."""
    return np.random.RandomState(seed).randint(3, hi, size=length).astype(np.int32)


@pytest.mark.parametrize("k", [2, 8, 13])
@pytest.mark.parametrize("n", [2, 3])
def test_drafters_propose_jax_tokens(k, n):
    """Buffer lengths from short to the buffer's end; buffers with and
    without matches; every drafter against JAX's, exactly."""
    for seed in range(4):
        row = _rows(seed, hi=9 if seed % 2 else 200)  # seed 0, 2: mostly no match
        L = row.shape[0]
        for bl in (2, 5, 17, 30, L - k, L - 1, L):
            token = row[bl - 1]
            args_j = (jnp.asarray(row), jnp.asarray(bl, jnp.int32), jnp.asarray(token))
            args_t = (torch.from_numpy(row), torch.tensor(bl, dtype=torch.int32), torch.tensor(token))
            want = np.asarray(jgen._ngram_propose_row(*args_j, k, n))
            got = tgen._ngram_propose_row(*args_t, k, n)
            assert got.dtype == torch.int32 and got.tolist() == want.tolist(), (seed, bl)
            want = np.asarray(jgen._longest_match_propose_row(*args_j, k))
            assert tgen._longest_match_propose_row(*args_t, k).tolist() == want.tolist(), (seed, bl)
            for drafter in ("ngram", "longest"):
                want = np.asarray(jgen.propose_row(drafter, *args_j, k, n))
                assert tgen.propose_row(drafter, *args_t, k, n).tolist() == want.tolist()
    buf = torch.from_numpy(_rows(9))[None]
    token = buf[:, 29:30]
    assert tgen._ngram_propose(buf, torch.tensor(30), token, 5, 3).tolist() == np.asarray(
        jgen._ngram_propose(jnp.asarray(buf.numpy()), jnp.asarray(30), jnp.asarray(token.numpy()), 5, 3)).tolist()
    with pytest.raises(ValueError, match="drafter"):
        tgen.propose_row("oracle", buf[0], torch.tensor(30), token[0, 0], 4, 3)


def test_longest_match_reduces_to_ngram_and_falls_back():
    """With n_max = min_match = n - 1 the longest-match drafter is the
    n-gram drafter; with no earlier occurrence both repeat the last token."""
    k, n = 6, 3
    for seed in range(8):
        row = torch.from_numpy(_rows(seed))
        for bl in (8, 17, 30, row.shape[0]):
            bl_t = torch.tensor(bl, dtype=torch.int32)
            assert torch.equal(tgen._ngram_propose_row(row, bl_t, row[bl - 1], k, n),
                               tgen._longest_match_propose_row(row, bl_t, row[bl - 1], k, n - 1, n - 1))
    row = torch.zeros(32, dtype=torch.int32)
    row[:6] = torch.tensor([3, 4, 5, 6, 7, 8])
    for fn in (lambda: tgen._longest_match_propose_row(row, torch.tensor(6), row[5], 5),
               lambda: tgen._ngram_propose_row(row, torch.tensor(6), row[5], 5, 3)):
        assert fn().tolist() == [8, 8, 8, 8]
    # The longer context wins over the more recent bigram (tests/test_speculative.py's case).
    row = torch.tensor([1, 2, 3, 4, 5, 9, 9, 6, 4, 5, 7, 7, 3, 4, 5], dtype=torch.int32)
    assert tgen._ngram_propose_row(row, torch.tensor(15), row[14], 4, 3).tolist() == [7, 7, 3]
    assert tgen._longest_match_propose_row(row, torch.tensor(15), row[14], 4).tolist() == [9, 9, 6]


# ---------------------------------------------------------------------------
# The decode attention's verify shape, verify_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("b,t,s,h,hkv,valid", [
    (1, 4, 40, 4, 1, [20]),
    (2, 7, 64, 8, 2, [30, 51]),
    (2, 16, 50, 2, 2, [3, 40]),  # row 1's last queries reach past S
])
def test_verify_attention_matches_jax_threshold_mask(kv, b, t, s, h, hkv, valid):
    """Query i of row b sees [0, valid[b] + i): JAX's per-query threshold
    mask through its gqa_attention, over the dequantized int8 cache too."""
    rng = np.random.RandomState(t + s)
    d = 16
    q = rng.randn(b, t, h, d).astype(np.float32)
    k, v = (rng.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = {}
    if kv == "int8":
        (tk, ks), (tv, vs) = gemma.quantize_kv_rows(tk), gemma.quantize_kv_rows(tv)
        kw = {"k_scale": ks, "v_scale": vs}
        k = (tk.float() * ks[..., None]).numpy()
        v = (tv.float() * vs[..., None]).numpy()
    valid_t = torch.tensor(valid, dtype=torch.int32)
    got = ca.decode_attention(tq, tk, tv, valid_t, **kw)  # a CPU tensor: the plain version
    allowed = np.arange(s)[None, None, :] < (np.asarray(valid)[:, None, None] + np.arange(t)[None, :, None])
    mask = np.where(allowed, 0.0, MASK_VALUE).astype(np.float32)[:, None, None, :, :]
    want = gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Each query row is the one-query call at its own visible length.
    for i in range(t):
        one = ca.decode_attention_plain(tq[:, i:i + 1], tk, tv, valid_t + i, **kw)
        np.testing.assert_allclose(got[:, i:i + 1].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def _prefilled(model, ids, pix, extra, cache_dtype=None):
    cache = tgen.make_cache(model, 1, ids.shape[1], extra, cache_dtype)
    return paligemma.prefill(model, torch.from_numpy(ids), torch.from_numpy(pix), cache)[1]


@pytest.mark.parametrize("kv", list(CACHES))
def test_verify_step_matches_jax_and_sequential_decode(setup, kv):
    cfg_j, params, model, mk = setup
    jdtype, tdtype = CACHES[kv]
    ids, pix = mk(1)
    toks = np.array([[7, 42, 99, 7]], np.int32)  # arbitrary drafts
    jcache = jgen.make_cache(cfg_j, 1, ids.shape[1], 8, jdtype)
    _, jcache = jpg.prefill(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jcache)
    want, jcache = jpg.verify_step(params, cfg_j, jnp.asarray(toks), jcache)

    cache = _prefilled(model, ids, pix, 8, tdtype)
    t = ids.shape[1]
    got, cache = paligemma.verify_step(model, torch.from_numpy(toks), cache)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 4, model.cfg.text_config.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert int(cache.length) == int(jcache.length) == t + 4 == cache.host_length
    assert cache.valid.tolist() == [t + 1]

    seq = _prefilled(model, ids, pix, 8, tdtype)
    rows = []
    for i in range(toks.shape[1]):
        lg, seq = paligemma.decode_step(model, torch.from_numpy(toks[:, i:i + 1]), seq)
        rows.append(lg[0, 0])
    np.testing.assert_allclose(got[0].numpy(), torch.stack(rows).numpy(), rtol=1e-5, atol=1e-5)
    # The K/V it wrote are the sequential steps', so either cache goes on alike.
    for name in ("k", "v") + (("k_scale", "v_scale") if kv == "int8" else ()):
        torch.testing.assert_close(getattr(cache, name)[:, :, :t + 4], getattr(seq, name)[:, :, :t + 4],
                                   rtol=1e-5, atol=1e-5 if kv == "float" else 1)
    # Rolled back to one accepted token, the next step sees only it.
    cache.length.fill_(t + 1)
    cache.host_length = t + 1
    one = _prefilled(model, ids, pix, 8, tdtype)
    _, one = paligemma.decode_step(model, torch.from_numpy(toks[:, :1]), one)
    lg_a, _ = paligemma.decode_step(model, torch.from_numpy(toks[:, 1:2]), cache)
    lg_b, _ = paligemma.decode_step(model, torch.from_numpy(toks[:, 1:2]), one)
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), rtol=1e-5, atol=1e-5)


def test_forward_keeps_the_prefill_check(setup):
    """T > 1 without multi_token_decode is a prefill, which needs an empty cache."""
    _, _, model, mk = setup
    ids, pix = mk(1)
    cache = _prefilled(model, ids, pix, 8)
    emb = gemma.embed_tokens(model.llm, torch.tensor([[5, 6]], dtype=torch.int32))
    with pytest.raises(ValueError, match="empty cache"):
        gemma.forward(model.llm, emb, torch.tensor([[0, 1]], dtype=torch.int32), cache)
    with pytest.raises(ValueError, match="needs a cache"):
        gemma.forward(model.llm, emb, torch.tensor([[0, 1]], dtype=torch.int32), None,
                      multi_token_decode=True)


# ---------------------------------------------------------------------------
# generate_spec
# ---------------------------------------------------------------------------


def _spec_pair(setup, seed, kv, max_new, eos, **kw):
    """(JAX's generate_spec tokens and stats, the port's)."""
    cfg_j, params, model, mk = setup
    jdtype, tdtype = CACHES[kv]
    ids, pix = mk(seed) if not isinstance(seed, tuple) else mk(*seed)
    stats_j, stats_t = {}, {}
    want = jgen.generate_spec(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), max_new, eos,
                              cache_dtype=jdtype, chunk=8, stats=stats_j, **kw)
    got = tgen.generate_spec(model, torch.from_numpy(ids), torch.from_numpy(pix), max_new, eos,
                             cache_dtype=tdtype, chunk=8, stats=stats_t, **kw)
    plain = tgen.generate_chunked(model, torch.from_numpy(ids), torch.from_numpy(pix), max_new, eos,
                                  cache_dtype=tdtype, chunk=8)
    return want, stats_j, got, stats_t, plain


@pytest.mark.parametrize("drafter", ["ngram", "longest"])
@pytest.mark.parametrize("k,n", [(4, 3), (8, 3), (6, 2)])
@pytest.mark.parametrize("kv", list(CACHES))
def test_generate_spec_matches_jax(setup, kv, k, n, drafter):
    """Tokens, produced and verify steps exactly JAX's, tokens the plain
    greedy stream's; a prompt that repeats itself shows acceptance."""
    pattern = [11, 12, 13, 14, 15, 11, 12, 13, 14, 15, 11, 12]
    for seed in (1, (5, pattern)):
        want, stats_j, got, stats_t, plain = _spec_pair(setup, seed, kv, 20, -1, k=k, n=n, drafter=drafter)
        assert got == want == plain and len(got) == 20, (seed, got, want, plain)
        assert stats_t == stats_j and stats_t["verify_steps"] >= 1, (stats_t, stats_j)
        assert stats_t["tokens_per_verify"] >= 1.0


@pytest.mark.parametrize("kv", list(CACHES))
def test_generate_spec_trims_at_eos(setup, kv):
    cfg_j, params, model, mk = setup
    ids, pix = mk(2)
    full = tgen.generate_chunked(model, torch.from_numpy(ids), torch.from_numpy(pix), 20, -1,
                                 cache_dtype=CACHES[kv][1], chunk=8)
    eos = next(x for i, x in enumerate(full) if i >= 3 and x not in full[:i])
    want, stats_j, got, stats_t, plain = _spec_pair(setup, 2, kv, 20, eos, k=4, n=3)
    assert got == want == plain and got[-1] == eos and eos not in got[:-1]
    assert stats_t == stats_j


def test_decode_steps_spec_returns_jax_state(setup):
    """One chunk from a prefilled cache: out_buf's produced columns,
    produced, iters, the last token, buf_len and the id buffer are JAX's;
    the cache length is the accepted count, its host mirror exact."""
    cfg_j, params, model, mk = setup
    ids, pix = mk(2)
    t, k = ids.shape[1], 4
    jcache = jgen.make_cache(cfg_j, 1, t, 40, jnp.float32)
    lg, jcache = jpg.prefill(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jcache)
    first = int(jnp.argmax(lg[0, -1]))
    L = t + 40
    ids_buf = np.zeros((1, L), np.int32)
    ids_buf[0, :t], ids_buf[0, t] = ids[0], first
    ref = jgen.decode_steps_spec(params, cfg_j, jnp.asarray([[first]], jnp.int32), jcache,
                                 jnp.asarray(ids_buf), jnp.asarray(t + 1, jnp.int32), 10, k, 3)
    cache = _prefilled(model, ids, pix, 40)
    got = tgen.decode_steps_spec(model, torch.tensor([[first]], dtype=torch.int32), cache,
                                 torch.from_numpy(ids_buf), torch.tensor(t + 1, dtype=torch.int32), 10, k=k)
    out_j, prod_j, iters_j, tok_j, jc, ids_j, bl_j = ref
    out_t, prod_t, iters_t, tok_t, cache, ids_t, bl_t = got
    p = int(prod_j)
    assert int(prod_t) == p >= 10 and int(iters_t) == int(iters_j) and int(bl_t) == int(bl_j)
    assert out_t.shape == (1, 10 + k) and out_t[0, :p].tolist() == np.asarray(out_j)[0, :p].tolist()
    assert tok_t.tolist() == np.asarray(tok_j).tolist()
    assert ids_t[0, :t + 1 + p].tolist() == np.asarray(ids_j)[0, :t + 1 + p].tolist()
    assert int(cache.length) == int(jc.length) == t + p == cache.host_length
    with pytest.raises(ValueError, match="batch-1"):
        tgen.decode_steps_spec(model, tok_t.repeat(2, 1), cache, ids_t, bl_t, 4, k=k)
    with pytest.raises(ValueError, match="cache full"):
        tgen.decode_steps_spec(model, tok_t, cache, ids_t, bl_t, 40, k=k)


def test_spec_sampled_near_zero_temperature_is_greedy_and_seeded(setup):
    _, _, model, mk = setup
    ids, pix = map(torch.from_numpy, mk(6))
    greedy = tgen.generate_chunked(model, ids, pix, 16, -1, chunk=8)

    def spec(seed, temperature):
        return tgen.generate_spec(model, ids, pix, 16, -1, chunk=8, k=4, n=3, do_sample=True,
                                  temperature=temperature, top_p=0.9,
                                  generator=torch.Generator().manual_seed(seed))

    assert spec(3, 1e-6) == greedy
    a = spec(3, 0.8)
    assert a == spec(3, 0.8) and a != spec(4, 0.8)


def test_spec_sampled_distribution_parity(setup):
    """The sampled speculative stream's per-position marginals against
    plain sampling's over the top tokens (a loose bar: it catches an
    acceptance bias, not noise; tests/test_speculative.py's check)."""
    _, _, model, mk = setup
    ids, pix = map(torch.from_numpy, mk(7))
    n_runs, max_new = 220, 3
    counts = {"plain": [collections.Counter() for _ in range(max_new)],
              "spec": [collections.Counter() for _ in range(max_new)]}
    for s in range(n_runs):
        kw = dict(do_sample=True, temperature=0.8, top_p=0.8)
        plain = tgen.generate_chunked(model, ids, pix, max_new, -1, chunk=4,
                                      generator=torch.Generator().manual_seed(1000 + s), **kw)
        spec = tgen.generate_spec(model, ids, pix, max_new, -1, chunk=4, k=3, n=2,
                                  generator=torch.Generator().manual_seed(5000 + s), **kw)
        for name, toks in (("plain", plain), ("spec", spec)):
            for pos, x in enumerate(toks):
                counts[name][pos][x] += 1
    for pos in range(max_new):
        p, q = counts["plain"][pos], counts["spec"][pos]
        top = [x for x, _ in (p + q).most_common(8)]
        l1_top = sum(abs(p[x] - q[x]) / n_runs for x in top)
        assert l1_top < 0.30, (pos, l1_top, p.most_common(5), q.most_common(5))


def test_spec_refuses_a_verify_deep_enough_for_prefill_a8(setup, monkeypatch):
    """With prefill_a8 a verify of A8_MIN_SEQ rows would take the int8 x
    int8 product while decode steps do not: the reference's guard."""
    _, _, model, mk = setup
    ids, pix = map(torch.from_numpy, mk(1))
    qmodel = quantization.quantize_params(model, mode="int8", prefill_a8=True)
    monkeypatch.setattr(quantization, "A8_MIN_SEQ", 8)
    with pytest.raises(ValueError, match="A8_MIN_SEQ"):
        tgen.generate_spec(qmodel, ids, pix, 12, -1, k=7)
    assert len(tgen.generate_spec(qmodel, ids, pix, 12, -1, chunk=8, k=6)) == 12
    assert len(tgen.generate_spec(model, ids, pix, 12, -1, chunk=8, k=7)) == 12

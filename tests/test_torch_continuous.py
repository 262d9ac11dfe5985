"""Continuous serving of the PyTorch port (``paligemma_tpu_torch/continuous.py``)
and the per-row cache writes under it, against the JAX package, on the CPU.

Tiny config, fp32, the same weights in both packages (``from_jax_params``),
the final norm redrawn so that greedy streams change token (drafts are then
accepted and rejected, and EOS occurs), the prompts and images of
``tests/test_continuous.py``.

- ``gemma.forward(row_lengths=...)`` against JAX's at T = 1 and in the
  verify shape, on the float and the int8 cache with ragged lengths: hidden
  states and written rows within 1e-5, written int8 rows equal; a row past
  the buffer writes clamped to its last position, and the engine's ``step``
  refuses an occupied slot that would pass its window.
- The port's ``ContinuousBatcher`` against JAX's on 2 slots, 4 requests
  (two queue), chunk 3: plain, speculative (k = 4, n-gram) and ``kv_quant``
  + ``kv_window``, every request's tokens equal.
- Join groups at the smallest group batch of ``join_batches`` that holds
  them (JAX's engine pads every group of 2 or more to ``n_slots``): groups
  of 3 and 5 at 8 slots join at 4 and 8 with JAX's tokens, and a staged
  wave of ``n_slots`` images feeds a smaller group its first rows.
- Ports of ``tests/test_continuous.py`` and ``tests/test_continuous_spec.py``
  (without the sharded engine; LoRA in ``test_torch_multi_lora.py``) against the port's batch-1
  ``generate``, and a free slot stepping past a shrunk window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from paligemma_tpu import continuous as jcont
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import gemma as jgemma
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.processing import ByteTokenizer as JByteTokenizer
from paligemma_tpu.processing import PaliGemmaProcessor as JProcessor
import paligemma_tpu_torch
from paligemma_tpu_torch import generation, quantization
from paligemma_tpu_torch import serving as tserving
from paligemma_tpu_torch.continuous import ContinuousBatcher, join_batches
from paligemma_tpu_torch.models import gemma
from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor
from paligemma_tpu_torch.utils.convert import from_jax_params

PROMPTS = ["a", "tell me more", "mid", "the longest prompt of them all"]


@pytest.fixture(scope="module")
def setup():
    cfg0 = j_tiny_config()
    tok = JByteTokenizer()
    pj = JProcessor(tok, cfg0.vision_config.num_image_tokens, cfg0.vision_config.image_size)
    cfg_j = dataclasses.replace(cfg0, image_token_index=pj.image_token_id,
                                vocab_size=max(cfg0.vocab_size, tok.vocab_size + 1200))
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    norm = params["llm"]["final_norm"]
    params["llm"]["final_norm"] = jnp.asarray(np.random.RandomState(3).randn(*norm.shape) * 2, jnp.float32)
    c0 = paligemma_tpu_torch.tiny_config()
    pt = PaliGemmaProcessor(ByteTokenizer(), c0.vision_config.num_image_tokens, c0.vision_config.image_size)
    cfg_t = dataclasses.replace(c0, image_token_index=pt.image_token_id, vocab_size=cfg_j.vocab_size)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    rng = np.random.RandomState(7)
    images = [Image.fromarray(rng.randint(0, 255, (20, 28, 3), np.uint8)) for _ in range(4)]
    return params, cfg_j, pj, model, pt, images


def oracle(setup, prompt, image, max_new):
    """The port's batch-1 ``generate`` (stops at EOS)."""
    _, _, _, model, pt, _ = setup
    out = pt(text=[prompt], images=[image])
    toks, _ = generation.generate(model, torch.from_numpy(out["input_ids"]),
                                  torch.from_numpy(out["pixel_values"]), max_new, pt.tokenizer.eos_token_id)
    return toks


def run_port(setup, subs, n_slots=2, chunk=3, max_new=9, **kw):
    _, _, _, model, pt, _ = setup
    eng = ContinuousBatcher(model, pt, n_slots=n_slots, max_new_tokens=max_new, chunk=chunk, **kw)
    try:
        reqs = [eng.submit(*args, **skw) for args, skw in subs]
        eng.run()
    finally:
        eng.close()
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return [r.tokens for r in reqs], eng


def _subs(setup, budgets):
    images = setup[5]
    return [((p, im), dict(max_new_tokens=m)) for p, im, m in zip(PROMPTS, images, budgets)]


# ---------------------------------------------------------------------------
# Per-row cache writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_per_row_forward_matches_jax(setup, t, kv):
    """Three rows at ragged lengths over a warm cache: hidden states and the
    rows written at ``row_lengths[b] + i`` equal JAX's within 1e-5, the int8
    rows exactly; the rows not written are untouched."""
    params, cfg_j, _, model, _, _ = setup
    tc = cfg_j.text_config
    b, s_len = 3, 24
    rng = np.random.RandomState(11 + t)
    lens = np.array([3, 17, 9], np.int32)
    shape = (tc.num_hidden_layers, b, s_len, tc.num_key_value_heads, tc.head_dim)
    k0, v0 = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    embeds = rng.randn(b, t, tc.hidden_size).astype(np.float32)
    positions = lens[:, None] + np.arange(t, dtype=np.int32)[None, :]
    int8 = kv == "int8"
    if int8:
        k0, v0 = (rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks0, vs0 = (rng.rand(*shape[:-1]).astype(np.float32) * 0.02 for _ in range(2))
        jc = jgemma.QuantKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), k_scale=jnp.asarray(ks0),
                                 v_scale=jnp.asarray(vs0), length=jnp.asarray(0, jnp.int32))
    else:
        jc = jgemma.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(0, jnp.int32))
    hj, jc2 = jgemma.forward(params["llm"], tc, jnp.asarray(embeds), jnp.asarray(positions), cache=jc,
                             row_lengths=jnp.asarray(lens), multi_token_decode=t > 1)
    tcache = gemma.init_cache(model.cfg.text_config, b, s_len, torch.int8 if int8 else torch.float32, "cpu")
    tcache.k.copy_(torch.from_numpy(k0))
    tcache.v.copy_(torch.from_numpy(v0))
    if int8:
        tcache.k_scale.copy_(torch.from_numpy(ks0))
        tcache.v_scale.copy_(torch.from_numpy(vs0))
    ht, _ = gemma.forward(model.llm, torch.from_numpy(embeds), torch.from_numpy(positions), tcache,
                          row_lengths=torch.from_numpy(lens), multi_token_decode=t > 1)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5, atol=1e-5)
    assert int(tcache.length) == 0 and tcache.host_length == 0  # the shared length is untouched
    assert tcache.valid.tolist() == (lens + 1).tolist()
    names = ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v")
    written = np.zeros((b, s_len), bool)
    for r in range(b):
        written[r, lens[r]: lens[r] + t] = True
    for name in names:
        got, want = getattr(tcache, name).numpy(), np.asarray(getattr(jc2, name))
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got[:, written], want[:, written], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got[:, ~written], want[:, ~written])


def test_per_row_forward_clamps_a_write_past_the_buffer(setup):
    """A row whose length passed the buffer (a free slot) writes clamped to
    its own last position, in both shapes; no other position changes."""
    model = setup[3]
    tc = model.cfg.text_config
    cache = gemma.init_cache(tc, 2, 10, torch.float32, "cpu")
    lens = torch.tensor([8, 30], dtype=torch.int32)
    gemma.forward(model.llm, torch.randn(2, 1, tc.hidden_size), lens[:, None], cache, row_lengths=lens)
    assert cache.k[:, 0, 8].abs().sum() > 0 and cache.k[:, 1, 9].abs().sum() > 0
    assert cache.k[:, :, :8].abs().sum() == 0 and cache.k[:, 0, 9].abs().sum() == 0
    assert cache.k[:, 1, 8].abs().sum() == 0
    gemma.forward(model.llm, torch.randn(2, 2, tc.hidden_size), lens[:, None] + torch.arange(2), cache,
                  row_lengths=lens, multi_token_decode=True)
    assert cache.k[:, 0, 9].abs().sum() > 0 and cache.k[:, 1, 8].abs().sum() == 0
    assert cache.k[:, :, :8].abs().sum() == 0
    assert int(cache.length) == 0 and cache.host_length == 0


def test_engine_step_refuses_an_overrun_of_its_host_mirror(setup):
    """An occupied slot whose host length plus the chunk's advance passes the
    window raises ``ValueError`` from ``step()`` before the chunk runs; the
    same length on a freed slot does not."""
    _, _, _, model, pt, images = setup
    eng = ContinuousBatcher(model, pt, n_slots=2, max_new_tokens=9, chunk=3)
    try:
        a = eng.submit(PROMPTS[0], images[0], max_new_tokens=9)
        b = eng.submit(PROMPTS[1], images[1], max_new_tokens=1)
        assert eng.step()  # both join, one chunk runs; b is done
        assert b.done and not a.done
        slot = eng.slot_req.index(a)
        free = 1 - slot
        assert eng.slot_req[free] is None
        eng.host_lengths[free] = eng.window  # a freed slot past the window is fine
        chunks = eng.chunks_run
        eng.host_lengths[slot] = eng.window - eng.chunk + 1
        with pytest.raises(ValueError, match="cache full"):
            eng.step()
        assert not a.done and eng.chunks_run == chunks + 1
        eng.host_lengths[slot] = eng.window - eng.chunk
        assert eng.step()
        assert eng.chunks_run == chunks + 2
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# The engine against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"spec_k": 4}, {"kv_quant": True, "kv_window": True}],
                         ids=["plain", "spec4", "kvquant_window"])
def test_engine_matches_jax_engine(setup, kw):
    params, cfg_j, pj, _, _, images = setup
    budgets = [5, 9, 3, 7]
    eng = jcont.ContinuousBatcher(params, cfg_j, pj, n_slots=2, max_new_tokens=9, chunk=3,
                                  cache_dtype=jnp.float32, prefetch=False, **kw)
    reqs = [eng.submit(p, im, max_new_tokens=m) for p, im, m in zip(PROMPTS, images, budgets)]
    eng.run()
    want = [r.tokens for r in reqs]
    got, teng = run_port(setup, _subs(setup, budgets), **kw)
    assert got == want, (got, want)
    assert len({len(x) for x in got}) > 1 and any(len(set(x)) > 1 for x in got)
    if "spec_k" in kw:
        assert teng.spec_emitted == eng.spec_emitted and teng.spec_verifies == eng.spec_verifies
    if "kv_window" in kw:
        assert teng.window_buckets == eng.window_buckets and teng.window_resizes == eng.window_resizes


# ---------------------------------------------------------------------------
# The engine against the port's batch-1 generate
# ---------------------------------------------------------------------------


def test_continuous_matches_batch1_with_queueing(setup):
    got, _ = run_port(setup, _subs(setup, [7, 7, 7, 7]), max_new=7)
    for p, im, toks in zip(PROMPTS, setup[5], got):
        assert toks == oracle(setup, p, im, 7)


def test_single_slot_eviction_and_reuse(setup):
    got, eng = run_port(setup, _subs(setup, [5, 5, 5]), n_slots=1, chunk=2, max_new=5)
    for p, im, toks in zip(PROMPTS, setup[5], got):
        assert toks == oracle(setup, p, im, 5)
    assert eng.join_groups == 3 and [(g_b, len(m)) for g_b, m in eng.join_log] == [(1, 1)] * 3
    assert [r.id for r in eng.completed] == [m[0] for _, m in eng.join_log]


def _engine(setup, **kw):
    model, pt = setup[3], setup[4]
    base = dict(n_slots=2, max_new_tokens=6, chunk=2)
    base.update(kw)
    return ContinuousBatcher(model, pt, **base)


def test_mid_flight_submit_and_budget_one(setup):
    images = setup[5]
    eng = _engine(setup)
    r0 = eng.submit(PROMPTS[0], images[0])
    eng.step()  # r0 in flight: the next joins overlap a running chunk
    r1 = eng.submit(PROMPTS[1], images[1], max_new_tokens=1)
    r2 = eng.submit(PROMPTS[2], images[2])
    eng.run()
    eng.close()
    assert r1.done and r1.tokens == oracle(setup, PROMPTS[1], images[1], 1)
    assert r0.tokens == oracle(setup, PROMPTS[0], images[0], 6)
    assert r2.tokens == oracle(setup, PROMPTS[2], images[2], 6)


def test_budget_guard_and_lora_refusal(setup):
    """The budget guard; an engine without ``lora_rank`` refuses adapters,
    as the reference's does."""
    eng = _engine(setup, n_slots=1, max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds the engine budget"):
        eng.submit(PROMPTS[0], setup[5][0], max_new_tokens=99)
    tc = setup[3].cfg.text_config
    ad = {n: {"a": torch.zeros(tc.num_hidden_layers, tc.hidden_size, 2),
              "b": torch.zeros(tc.num_hidden_layers, 2, 8)} for n in ("q", "k", "v")}
    with pytest.raises(ValueError, match="without lora_rank"):
        eng.register_adapter("fin", ad, 1.0)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(PROMPTS[0], setup[5][0], adapter="fin")
    eng.close()


def test_mixed_greedy_and_sampled_slots(setup):
    images = setup[5]
    eng = _engine(setup)
    rg = eng.submit(PROMPTS[0], images[0])
    rs = eng.submit(PROMPTS[1], images[1], temperature=0.9, top_p=0.9, do_sample=True)
    eng.run()
    eng.close()
    assert rg.tokens == oracle(setup, PROMPTS[0], images[0], 6)
    assert 1 <= len(rs.tokens) <= 6 and all(0 <= t < setup[1].text_config.vocab_size for t in rs.tokens)


def test_sampled_engine_repeats_under_its_seed(setup):
    images = setup[5]

    def run(seed):
        eng = _engine(setup, seed=seed, max_new_tokens=8)
        rs = [eng.submit(PROMPTS[i], images[i], do_sample=True, temperature=1.5, top_p=0.95) for i in range(3)]
        eng.run()
        eng.close()
        return [r.tokens for r in rs]

    assert run(1) == run(1)
    assert run(1) != run(2)


def test_streaming_hook_and_cancellation(setup):
    images = setup[5]
    eng = _engine(setup, max_new_tokens=8)
    streamed, dones = [], []
    r0 = eng.submit(PROMPTS[0], images[0])
    r0.on_tokens = lambda toks, done: (streamed.extend(toks), dones.append(done))
    eng.run()
    assert streamed == r0.tokens and dones[-1] is True
    r1 = eng.submit(PROMPTS[1], images[1], max_new_tokens=8)
    events = []
    r1.on_tokens = lambda toks, done: events.append((list(toks), done))
    eng.step()
    produced = len(r1.tokens)
    r1.cancelled = True  # active: evicted at the next chunk boundary, told through the hook
    eng.run()
    assert r1.done and len(r1.tokens) <= produced + 1 and events[-1][1] is True
    q0 = eng.submit(PROMPTS[0], images[0])
    q1 = eng.submit(PROMPTS[1], images[1])
    q2 = eng.submit(PROMPTS[2], images[2])  # queued behind two slots
    eng.step()
    q2.cancelled = True
    eng.run()
    eng.close()
    assert q2.done and q2.tokens == [] and q0.done and q1.done


def test_prompt_buckets(setup):
    images = setup[5]
    n_img = setup[3].cfg.vision_config.num_image_tokens
    long_prompt = "a financial document with many words " * 3
    eng = _engine(setup, max_new_tokens=5, prompt_budget=[n_img + 8, n_img + 160])
    r_short = eng.submit(PROMPTS[0], images[0])
    eng.run()
    r_long = eng.submit(long_prompt, images[1])
    eng.run()
    assert r_short.tokens == oracle(setup, PROMPTS[0], images[0], 5)
    assert r_long.tokens == oracle(setup, long_prompt, images[1], 5)
    r_s2 = eng.submit(PROMPTS[1], images[0])
    r_l2 = eng.submit(long_prompt, images[1])  # one group at the covering bucket
    eng.run()
    assert r_s2.tokens == oracle(setup, PROMPTS[1], images[0], 5) and r_l2.tokens == r_long.tokens
    r_huge = eng.submit("x" * 4000, images[0])
    eng.run()
    eng.close()
    assert r_huge.error is not None and "exceeds the largest prompt budget" in str(r_huge.error)
    assert sorted(k for k in eng._prefills) == [(1, n_img + 8), (1, n_img + 160), (2, n_img + 160)]


@pytest.mark.parametrize("n_slots, want", [(1, (1,)), (2, (1, 2)), (8, (1, 2, 4, 8)),
                                            (24, (1, 2, 4, 8, 16, 24)), (32, (1, 2, 4, 8, 16, 32))])
def test_join_batches(n_slots, want):
    assert join_batches(n_slots) == want


def _two_groups(eng, setup):
    """A group of 3 joins on free slots and runs a chunk; 5 more submitted
    then join as one group in the 5 slots left, while the 3 decode."""
    images = setup[5]
    first = [eng.submit(PROMPTS[i], images[i], max_new_tokens=9) for i in range(3)]
    eng.step()
    second = [eng.submit(PROMPTS[i % 4], images[(i + 1) % 4], max_new_tokens=m)
              for i, m in zip(range(3, 8), [4, 7, 9, 5, 6])]
    eng.run()
    return first + second


def test_groups_join_at_the_smallest_batch_that_holds_them(setup):
    params, cfg_j, pj, model, pt, images = setup
    jeng = jcont.ContinuousBatcher(params, cfg_j, pj, n_slots=8, max_new_tokens=9, chunk=3,
                                   cache_dtype=jnp.float32, prefetch=False)
    want = [r.tokens for r in _two_groups(jeng, setup)]
    eng = ContinuousBatcher(model, pt, n_slots=8, max_new_tokens=9, chunk=3, prefetch=False)
    reqs = _two_groups(eng, setup)
    eng.close()
    assert all(r.done and r.error is None for r in reqs)
    assert list(eng.join_log) == [(4, tuple(r.id for r in reqs[:3])), (8, tuple(r.id for r in reqs[3:]))]
    assert eng.join_rows == 12 and eng.join_pad_rows == 4
    assert sorted(eng._prefills) == [(4, eng.prompt_budget), (8, eng.prompt_budget)]
    assert [r.tokens for r in reqs] == want
    for i, r in enumerate(reqs):
        assert r.tokens == oracle(setup, r.prompt, r.image, r.max_new_tokens), i


def test_staged_wave_feeds_a_smaller_group_its_first_rows(setup):
    images = setup[5]
    eng = _engine(setup, n_slots=4, max_new_tokens=9, chunk=3, prefetch=False)
    held = [eng.submit(PROMPTS[i], images[i], max_new_tokens=9) for i in (0, 1)]
    eng.step()  # the two join and keep two slots
    wave = [eng.submit(PROMPTS[i], images[3 - i], max_new_tokens=5) for i in range(4)]
    for r in wave:
        r.prep = eng._preprocess_one(r)
    eng._try_stage()
    assert [sids for sids, _, _ in eng._staged] == [tuple(r.id for r in wave)]
    eng.run()
    eng.close()
    assert eng.staged_hits == 1 and eng.join_log[1] == (2, (wave[0].id, wave[1].id))
    for r in held + wave:
        assert r.error is None and r.tokens == oracle(setup, r.prompt, r.image, r.max_new_tokens)


def test_prefill_cache_hit_identity_and_eviction(setup, monkeypatch):
    """A repeated (prompt, image) joins from the prefix cache: the same
    tokens, no second prefill; a miss evicts the only entry (size 1)."""
    images = setup[5]
    calls = []
    orig = tserving.batched_prefill
    monkeypatch.setattr(tserving, "batched_prefill", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    eng = _engine(setup, n_slots=1, max_new_tokens=5, prefill_cache_size=1)
    r1 = eng.submit(PROMPTS[0], images[0])
    eng.run()
    n_first = len(calls)
    r2 = eng.submit(PROMPTS[0], images[0])
    eng.run()
    assert len(calls) == n_first and eng.prefill_cache_hits == 1
    assert r2.tokens == r1.tokens == oracle(setup, PROMPTS[0], images[0], 5)
    eng.submit(PROMPTS[0], images[1])  # a miss, which evicts the entry
    eng.run()
    assert len(calls) == n_first + 1
    eng.submit(PROMPTS[0], images[0])  # evicted: prefills again
    eng.run()
    eng.close()
    assert len(calls) == n_first + 2 and eng.prefill_cache_hits == 1


def test_prefill_cache_entry_survives_other_joins(setup):
    """The entry's K/V and logits are copies: joins in between (which
    overwrite the join runner's buffers) do not change a hit's tokens."""
    images = setup[5]
    eng = _engine(setup, n_slots=1, max_new_tokens=5, prefill_cache_size=2)
    r1 = eng.submit(PROMPTS[0], images[0])
    eng.run()
    eng.submit(PROMPTS[0], images[1])  # same prompt length: the same runner
    eng.run()
    r3 = eng.submit(PROMPTS[0], images[0])
    eng.run()
    eng.close()
    assert eng.prefill_cache_hits == 1 and r3.tokens == r1.tokens == oracle(setup, PROMPTS[0], images[0], 5)


def test_kv_window_identity_with_resizes_and_a_free_slot_past_it(setup):
    """The window engine gives the full-cache engine's tokens while the
    window grows and shrinks; a free slot whose stale length has passed a
    shrunk window keeps stepping (its writes clamped to its own rows), and
    the request that joins the other slot still gives batch 1's tokens."""
    images = setup[5]

    def run(**kw):
        eng = _engine(setup, max_new_tokens=160, chunk=4, **kw)
        long_r = eng.submit(PROMPTS[0], images[0], max_new_tokens=140)
        short = eng.submit(PROMPTS[1], images[1], max_new_tokens=6)
        while not long_r.done:
            eng.step()
        late = eng.submit(PROMPTS[2], images[2], max_new_tokens=30)  # joins slot 0
        past = False
        while eng.step():
            past |= int(eng.state.lengths[1]) > eng.window
        eng.close()
        return [r.tokens for r in (long_r, short, late)], eng, past

    base, _, _ = run()
    win, eng, past = run(kv_window=True)
    assert win == base
    assert eng.window_resizes >= 2 and past, (eng.window_buckets, eng.window)
    assert win[2] == oracle(setup, PROMPTS[2], images[2], 30)
    assert win[0] == oracle(setup, PROMPTS[0], images[0], 140)


def test_kv_quant_engine_with_window_and_spec(setup):
    subs = _subs(setup, [5, 9, 3, 7])
    base, _ = run_port(setup, subs, kv_quant=True)
    assert run_port(setup, subs, kv_quant=True, kv_window=True)[0] == base
    assert run_port(setup, subs, kv_quant=True, spec_k=3)[0] == base


def test_prefetch_identity_and_shutdown(setup):
    images = setup[5]

    def run(pf):
        eng = _engine(setup, prefetch=pf)
        reqs = [eng.submit(p, im) for p, im in zip(PROMPTS[:3], images[:3])]
        eng.step()
        reqs.append(eng.submit(PROMPTS[3], images[3]))  # racing the worker
        eng.run()
        assert all(r.done and r.error is None for r in reqs)
        assert (eng._prefetch_thread is not None) == pf
        eng.close()
        eng.close()
        if pf:
            eng._prefetch_thread.join(timeout=5.0)
            assert not eng._prefetch_thread.is_alive()
        return [r.tokens for r in reqs]

    assert run(True) == run(False)


@pytest.mark.parametrize("cancel_one", [False, True])
def test_staged_group_upload_hit_and_fallback(setup, cancel_one):
    images = setup[5]
    eng = _engine(setup, max_new_tokens=5, prefetch=False)
    reqs = [eng.submit(p, im) for p, im in zip(PROMPTS, images)]
    for r in list(eng.pending)[: eng.n_slots]:
        r.prep = eng._preprocess_one(r)
    eng._try_stage()
    assert len(eng._staged) == 1
    if cancel_one:
        reqs[0].cancelled = True
    eng.run()
    eng.close()
    if cancel_one:
        assert eng.staged_misses >= 1 and eng.staged_hits == 0
    else:
        assert eng.staged_hits >= 1
    for p, im, r in zip(PROMPTS, images, reqs):
        if not r.cancelled:
            assert r.error is None and r.tokens == oracle(setup, p, im, 5)


def test_pixel_affine_gate(setup):
    """The engine takes the affine only where it equals the gather over the
    0..255 ramp in its pixel dtype: not in fp32 (one ulp apart, as in the
    reference's fp32 engine), in bf16 yes."""
    import copy

    eng = _engine(setup)
    eng.close()
    assert eng.pixel_affine is False and eng._pixel_aff is None
    eng = ContinuousBatcher(copy.deepcopy(setup[3]).to(torch.bfloat16), setup[4], n_slots=1)
    eng.close()
    assert eng.pixel_affine is True


# ---------------------------------------------------------------------------
# Speculative chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drafter", ["ngram", "longest"])
def test_spec_engine_identical_to_plain(setup, drafter):
    subs = _subs(setup, [5, 9, 3, 7])
    base, _ = run_port(setup, subs)
    for k in (2, 4, 16):
        spec, eng = run_port(setup, subs, spec_k=k, spec_drafter=drafter)
        assert spec == base, (k, spec, base)
        assert eng.spec_verifies > 0


def test_spec_engine_mixed_sampling_and_near_zero_temperature(setup):
    images = setup[5]
    subs = [((PROMPTS[0], images[0]), dict(max_new_tokens=6)),
            ((PROMPTS[1], images[1]), dict(max_new_tokens=6, do_sample=True, temperature=0.9)),
            ((PROMPTS[2], images[2]), dict(max_new_tokens=4))]
    base, _ = run_port(setup, subs)
    spec, _ = run_port(setup, subs, spec_k=3)
    assert spec[0] == base[0] and spec[2] == base[2] and 1 <= len(spec[1]) <= 6
    greedy_subs = [((PROMPTS[i], images[i]), dict(max_new_tokens=7)) for i in range(2)]
    near_zero = [((PROMPTS[i], images[i]), dict(max_new_tokens=7, do_sample=True, temperature=1e-6))
                 for i in range(2)]
    base, _ = run_port(setup, greedy_subs)
    spec, eng = run_port(setup, near_zero, spec_k=4)
    assert spec == base and eng.spec_verifies > 0


def test_draft_noise_streams_exact_and_acceptance_drops(setup):
    subs = _subs(setup, [9, 7, 5, 8])
    base, _ = run_port(setup, subs)
    clean, e_clean = run_port(setup, subs, spec_k=4)
    noisy, e_noisy = run_port(setup, subs, spec_k=4, draft_noise=1.0)
    assert noisy == base == clean
    assert e_noisy.spec_emitted / e_noisy.spec_verifies < e_clean.spec_emitted / e_clean.spec_verifies


def test_adaptive_engine_identical_to_plain(setup):
    subs = _subs(setup, [9, 3, 7, 5])
    base, _ = run_port(setup, subs)
    spec, eng = run_port(setup, subs, spec_k=3, spec_adaptive=True, spec_max_slots=1)
    assert spec == base
    assert True in eng.spec_mode_log and False in eng.spec_mode_log


def test_adaptive_low_acceptance_demotes_and_probes(setup):
    subs = [((PROMPTS[0], setup[5][0]), dict(max_new_tokens=12))]
    base, _ = run_port(setup, subs, max_new=12)
    spec, eng = run_port(setup, subs, max_new=12, spec_k=3, spec_adaptive=True, spec_max_slots=2,
                         spec_min_accept=100.0, spec_probe_every=2)
    assert spec == base
    log = eng.spec_mode_log
    assert log[0] is True
    for i, mode in enumerate(log[1:], start=1):
        if mode:
            assert log[i - 2: i] == [False, False], (i, log)
    assert eng.spec_accept_ema is not None


def test_ladder_engine_and_policy(setup):
    subs = _subs(setup, [9, 5, 7, 8])
    base, _ = run_port(setup, subs)
    lad, eng = run_port(setup, subs, spec_ks=(2, 4), spec_adaptive=True, spec_max_slots=2)
    assert lad == base and eng.spec_k == 4 and set(eng.spec_k_log) <= {0, 2, 4}
    eng = _engine(setup, chunk=4, spec_ks=(4, 8), spec_adaptive=True, spec_max_slots=2, spec_probe_every=2)
    eng.close()
    assert eng._decide_spec_mode(1) == 4
    eng.spec_accept_ema = 3.6
    assert eng._decide_spec_mode(1) == 8 and eng.spec_accept_ema is None
    eng.spec_accept_ema = 1.5
    assert eng._decide_spec_mode(1) == 4 and eng.spec_accept_ema is None
    eng.spec_accept_ema = 1.0
    assert eng._decide_spec_mode(1) == 0
    assert eng._decide_spec_mode(1) == 4 and eng._probing
    eng._probing, eng._chunks_since_spec, eng._probe_interval = False, 0, 4
    assert eng._decide_spec_mode(1) == 0
    eng.spec_accept_ema = 4.0
    assert eng._decide_spec_mode(3) == 0


def test_spec_engine_prefill_cache(setup):
    images = setup[5]
    eng = _engine(setup, n_slots=1, max_new_tokens=5, spec_k=3, prefill_cache_size=2)
    r1 = eng.submit(PROMPTS[0], images[0])
    eng.run()
    r2 = eng.submit(PROMPTS[0], images[0])
    eng.run()
    eng.close()
    assert eng.prefill_cache_hits == 1 and r1.tokens == r2.tokens == oracle(setup, PROMPTS[0], images[0], 5)


def test_spec_depth_rejected_under_a8(setup):
    model = quantization.quantize_params(setup[3], llm_only=True, mode="int8", prefill_a8=True)
    with pytest.raises(ValueError, match="A8_MIN_SEQ"):
        ContinuousBatcher(model, setup[4], n_slots=2, max_new_tokens=4, chunk=2,
                          spec_k=quantization.A8_MIN_SEQ - 1)
    ContinuousBatcher(model, setup[4], n_slots=2, max_new_tokens=4, chunk=2,
                      spec_k=quantization.A8_MIN_SEQ - 2).close()

"""Batched serving of the PyTorch port (``paligemma_tpu_torch/serving.py``)
against the JAX package's, on the CPU (tiny config, fp32, the same weights).

Every row of an 8-way ragged batch must give the greedy tokens of its sample
run alone at batch 1 through the port's ``generate``, and JAX's
``batch_generate`` tokens; EOS trims between chunks; shape bucketing
changes no output; stale K/V in the cache's pad slots and unwritten
positions change nothing; and the plain decode attention with the window's
end as a tensor equals the host int's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from paligemma_tpu import serving as jserving
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.processing import ByteTokenizer as JByteTokenizer
from paligemma_tpu.processing import PaliGemmaProcessor as JProcessor
import paligemma_tpu_torch
from paligemma_tpu_torch import generation, serving
from paligemma_tpu_torch.models import gemma
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.ops import kernels
from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor
from paligemma_tpu_torch.utils.convert import from_jax_params

N = 6  # new tokens a row


@pytest.fixture(scope="module")
def setup():
    """The same weights in both packages, the final norm drawn so that greedy
    streams change token; both processors; eight ragged samples."""
    cfg0 = j_tiny_config()
    tok = JByteTokenizer()
    pj = JProcessor(tok, cfg0.vision_config.num_image_tokens, cfg0.vision_config.image_size)
    cfg_j = dataclasses.replace(cfg0, image_token_index=pj.image_token_id,
                                vocab_size=max(cfg0.vocab_size, tok.vocab_size + 1200))
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.RandomState(7)
    params["llm"]["final_norm"] = jnp.asarray(rng.randn(*params["llm"]["final_norm"].shape) * 2, jnp.float32)
    c0 = paligemma_tpu_torch.tiny_config()
    pt = PaliGemmaProcessor(ByteTokenizer(), c0.vision_config.num_image_tokens, c0.vision_config.image_size)
    cfg_t = dataclasses.replace(c0, image_token_index=pt.image_token_id, vocab_size=cfg_j.vocab_size)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    images = [Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)) for _ in range(8)]
    prompts = [f"describe item {i} please" + " extra" * (i % 3) for i in range(8)]
    return params, cfg_j, pj, model, pt, prompts, images


def _batch1(model, proc, prompt, image, n=N):
    out = proc(text=[prompt], images=[image])
    toks, _ = generation.generate(model, torch.from_numpy(out["input_ids"]),
                                  torch.from_numpy(out["pixel_values"]), n, -1, stop_at_eos=False)
    return toks


def test_pad_batch_shapes(setup):
    _, _, pj, _, pt, prompts, images = setup
    ids, valid, pix, real_b = serving.pad_batch(pt, prompts, images)
    assert real_b == 8 and ids.shape[0] == 8 and pix.shape == (8, 3, 32, 32)
    assert valid.max() == ids.shape[1] and len(set(valid.tolist())) > 1
    assert all(np.all(ids[i, valid[i]:] == 0) for i in range(8))
    want = jserving.pad_batch(pj, prompts, images)
    for got, ref in zip((ids, valid, pix), want[:3]):
        np.testing.assert_array_equal(got, ref)
    ids_b, valid_b, pix_b, real_b = serving.pad_batch(pt, prompts[:3], images[:3], prompt_bucket=64, batch_bucket=4)
    assert ids_b.shape == (4, 64) and real_b == 3 and valid_b[3] == valid_b[0] and pix_b.shape[0] == 4


def test_ragged_batch_rows_give_batch1_and_jax_tokens(setup):
    """Each row of an 8-way ragged batch: the greedy tokens of its sample at
    batch 1 through the port's ``generate``, and JAX's ``batch_generate``."""
    params, cfg_j, pj, model, pt, prompts, images = setup
    texts, rows = serving.batch_generate(model, pt, prompts, images, max_new_tokens=N, eos_token_id=-1,
                                         return_tokens=True)
    j_texts, j_rows = jserving.batch_generate(params, cfg_j, pj, prompts, images, max_new_tokens=N,
                                              cache_dtype=jnp.float32, eos_token_id=-1, return_tokens=True)
    assert rows == j_rows and texts == j_texts
    assert len({tuple(r) for r in rows}) > 1 and any(len(set(r)) > 1 for r in rows)  # streams that change
    for i in range(8):
        assert rows[i] == _batch1(model, pt, prompts[i], images[i]), i


def test_batched_prefill_logits_match_jax(setup):
    params, cfg_j, pj, model, pt, prompts, images = setup
    ids, valid, pix, _ = serving.pad_batch(pt, prompts, images)
    cache = generation.make_cache(model, 8, ids.shape[1], 4)
    got, cache = serving.batched_prefill(model, torch.from_numpy(ids), torch.from_numpy(pix),
                                         torch.from_numpy(valid), cache)
    from paligemma_tpu import generation as jgen

    jcache = jgen.make_cache(cfg_j, 8, ids.shape[1], 4, jnp.float32)
    want, _ = jserving.batched_prefill(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(valid), jcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert cache.host_length == ids.shape[1]


def test_eos_trims_between_chunks(setup):
    """A row stops at its first EOS (kept), as JAX's ``batch_generate`` stops
    it; the other rows run on."""
    params, cfg_j, pj, model, pt, prompts, images = setup
    _, free = serving.batch_generate(model, pt, prompts[:3], images[:3], max_new_tokens=40, eos_token_id=-1,
                                     return_tokens=True)
    row, stop = next((r, i) for r in range(3) for i in range(1, 40) if free[r][i] not in free[r][:i])
    eos = free[row][stop]  # a token that first comes at position stop of that row
    texts, rows = serving.batch_generate(model, pt, prompts[:3], images[:3], max_new_tokens=40, eos_token_id=eos,
                                         return_tokens=True)
    for got, ref in zip(rows, free):
        assert got == (ref[: ref.index(eos) + 1] if eos in ref else ref)
    assert len(rows[row]) == stop + 1 and len(texts) == 3
    _, j_rows = jserving.batch_generate(params, cfg_j, pj, prompts[:3], images[:3], max_new_tokens=40,
                                        cache_dtype=jnp.float32, eos_token_id=eos, return_tokens=True)
    assert rows == j_rows
    outs = serving.batch_generate(model, pt, prompts[:2], images[:2], max_new_tokens=4)  # the tokenizer's EOS
    assert len(outs) == 2 and all(isinstance(o, str) for o in outs)


def test_bucketing_does_not_change_outputs(setup):
    _, _, _, model, pt, prompts, images = setup
    plain = serving.batch_generate(model, pt, prompts[:3], images[:3], max_new_tokens=5, eos_token_id=-1)
    texts, tokens = serving.batch_generate(model, pt, prompts[:3], images[:3], max_new_tokens=5, eos_token_id=-1,
                                           prompt_bucket=64, batch_bucket=4, return_tokens=True)
    assert texts == plain and len(tokens) == 3 and all(len(t) == 5 for t in tokens)


def test_stale_cache_rows_are_never_seen(setup):
    """Poisoned K/V in every slot before the prefill (pad slots, unwritten
    positions, a pooled cache's last request) change no logits or token."""
    _, _, _, model, pt, prompts, images = setup
    ids, valid, pix = (torch.from_numpy(x) for x in serving.pad_batch(pt, prompts[:4], images[:4])[:3])
    t = ids.shape[1]

    def run(poison):
        cache = generation.make_cache(model, 4, t, 2 * serving.CHUNK)
        if poison:
            cache.k.fill_(1e4)
            cache.v.fill_(-1e4)
        logits, cache = serving.batched_prefill(model, ids, pix, valid, cache)
        first = logits.argmax(-1).to(torch.int32)[:, None]
        toks, _, cache = serving.batched_decode_steps(model, first, cache, valid, 9, t)
        return logits, toks

    (lc, tc), (lp, tp) = run(False), run(True)
    assert torch.equal(lc, lp) and torch.equal(tc, tp)


def test_batched_decode_steps_chunks_continue(setup):
    """Two chunks give the tokens of one chunk of their length, and one
    ``batched_decode_step`` the first of them."""
    _, _, _, model, pt, prompts, images = setup
    ids, valid, pix = (torch.from_numpy(x) for x in serving.pad_batch(pt, prompts[:3], images[:3])[:3])
    t = ids.shape[1]

    def start():
        cache = generation.make_cache(model, 3, t, 16)
        logits, cache = serving.batched_prefill(model, ids, pix, valid, cache)
        return logits.argmax(-1).to(torch.int32)[:, None], cache

    first, cache = start()
    whole, _, _ = serving.batched_decode_steps(model, first, cache, valid, 8, t)
    first, cache = start()
    a, last, cache = serving.batched_decode_steps(model, first, cache, valid, 3, t)
    b, _, cache = serving.batched_decode_steps(model, last, cache, valid, 5, t)
    assert torch.equal(torch.cat([a, b], dim=1), whole) and cache.host_length == t + 8
    first, cache = start()
    one, cache = serving.batched_decode_step(model, first, cache, valid, t)
    assert torch.equal(one, whole[:, 0])


@pytest.mark.parametrize("kv_int8", [False, True])
def test_plain_decode_takes_a_tensor_window_end(kv_int8):
    """The plain decode attention with ``gen_end`` as a one-element tensor
    (as batched serving's step computes it on the device) equals it with the
    host int, and masks the rows past it."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, hkv, d = 3, 40, 4, 2, 8
    q = torch.randn(b, 1, h, d, generator=gen)
    k, v = torch.randn(b, s, hkv, d, generator=gen), torch.randn(b, s, hkv, d, generator=gen)
    kw = {}
    if kv_int8:
        (k, ks), (v, vs) = gemma.quantize_kv_rows(k), gemma.quantize_kv_rows(v)
        kw = {"k_scale": ks, "v_scale": vs}
    valid = torch.tensor([20, 9, 17], dtype=torch.int32)
    for end in (21, 25, 30):
        host = ca.decode_attention_plain(q, k, v, valid, gen_start=20, gen_end=end, **kw)
        for t in (torch.tensor(end, dtype=torch.int32), torch.tensor([end], dtype=torch.int32)):
            assert torch.equal(ca.decode_attention(q, k, v, valid, gen_start=20, gen_end=t, **kw), host)
        k2, v2 = k.clone(), v.clone()
        k2[:, end:], v2[:, end:] = 100, 100
        assert torch.equal(ca.decode_attention_plain(q, k2, v2, valid, gen_start=20,
                                                     gen_end=torch.tensor(end, dtype=torch.int32), **kw), host)


def test_batched_serving_on_the_cpu_launches_no_kernel(setup):
    _, _, _, model, pt, prompts, images = setup
    before = kernels.launch_counts()
    serving.batch_generate(model, pt, prompts[:2], images[:2], max_new_tokens=3, eos_token_id=-1)
    assert kernels.launch_counts() == before

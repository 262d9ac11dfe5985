"""Multi-tenant LoRA in the port's continuous engine
(``paligemma_tpu_torch/continuous.py`` with ``lora_rank``) against the JAX
engine on the CPU: the invariants of ``tests/test_multi_lora.py``, with the
JAX engine's tokens as the oracle.

Tiny config, fp32, the same weights (``from_jax_params``) and adapters
(``lora_from_jax``) in both packages, the final norm redrawn so that greedy
streams change token.

- ``gemma.forward`` with per-row adapters [X, zeros] equals the shared
  adapter's forward and the base forward row by row (within 2e-5), and JAX's.
- An engine with ``lora_rank`` gives a request without an adapter the base
  engine's tokens; two adapters side by side each give what they give
  alone; every request's tokens equal the JAX engine's (plain chunks, and
  speculative chunks with k = 4); adapted tokens differ from the base's.
- A slot reused after an adapted request serves a base request exactly.
- Adapters over the int8 base: the base request is the int8 engine's, the
  adapted one the JAX int8 engine's and not the base's.
- The prefix cache keys on the adapter; unknown names, a rank above the
  engine's and an engine without ``lora_rank`` are refused; a rank below
  it is zero-padded exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from paligemma_tpu import continuous as jcont
from paligemma_tpu import lora as jlora
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import gemma as jgemma
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.processing import ByteTokenizer as JByteTokenizer
from paligemma_tpu.processing import PaliGemmaProcessor as JProcessor
from paligemma_tpu.processing import align_config as j_align_config
from paligemma_tpu.quantization import quantize_params as j_quantize_params
import paligemma_tpu_torch
from paligemma_tpu_torch import quantization
from paligemma_tpu_torch.continuous import ContinuousBatcher
from paligemma_tpu_torch.models import gemma
from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor, align_config
from paligemma_tpu_torch.utils.convert import from_jax_params, lora_from_jax

PROMPTS = ["alpha", "beta prompt", "gamma"]


@pytest.fixture(scope="module")
def setup():
    cfg0 = j_tiny_config()
    pj = JProcessor(JByteTokenizer(), cfg0.vision_config.num_image_tokens, cfg0.vision_config.image_size)
    cfg_j = j_align_config(cfg0, pj)
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(0), jnp.float32)
    norm = params["llm"]["final_norm"]
    params["llm"]["final_norm"] = jnp.asarray(np.random.RandomState(3).randn(*norm.shape) * 2, jnp.float32)
    c0 = paligemma_tpu_torch.tiny_config()
    pt = PaliGemmaProcessor(ByteTokenizer(), c0.vision_config.num_image_tokens, c0.vision_config.image_size)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), align_config(c0, pt), device="cpu")
    rng = np.random.RandomState(3)
    images = [Image.fromarray(rng.randint(0, 255, (24, 20, 3), np.uint8)) for _ in range(3)]
    return params, cfg_j, pj, model, pt, images


def random_adapter(cfg, r, seed, scale_b=0.5):
    """A JAX adapter (numpy) with non-zero B, and its scale."""
    lcfg = jlora.LoraConfig(r=r, alpha=2 * r, dropout=0.0)
    ad = jax.tree_util.tree_map(np.asarray, jlora.init_lora(cfg, lcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 100)
    for mod in ad["layers"].values():
        mod["b"] = (rng.randn(*mod["b"].shape) * scale_b).astype(np.float32)
    return ad, lcfg.scale


def port_tokens(setup, reqs, n_slots=2, lora_rank=None, adapters=(), max_new=6, model=None, **kw):
    _, _, _, tmodel, pt, images = setup
    eng = ContinuousBatcher(model or tmodel, pt, n_slots=n_slots, max_new_tokens=max_new, chunk=2,
                            lora_rank=lora_rank, **kw)
    try:
        for name, ad, scale in adapters:
            eng.register_adapter(name, lora_from_jax(ad, device="cpu"), scale)
        out = [eng.submit(PROMPTS[i], images[i], adapter=a) for i, a in reqs]
        eng.run()
    finally:
        eng.close()
    assert all(r.done and r.error is None for r in out), [r.error for r in out]
    return [r.tokens for r in out]


def jax_tokens(setup, reqs, n_slots=2, lora_rank=None, adapters=(), max_new=6, params=None, **kw):
    jparams, cfg_j, pj, _, _, images = setup
    eng = jcont.ContinuousBatcher(params or jparams, cfg_j, pj, n_slots=n_slots, max_new_tokens=max_new, chunk=2,
                                  cache_dtype=jnp.float32, lora_rank=lora_rank, prefetch=False, **kw)
    for name, ad, scale in adapters:
        eng.register_adapter(name, jax.tree_util.tree_map(jnp.asarray, ad), scale)
    out = [eng.submit(PROMPTS[i], images[i], adapter=a) for i, a in reqs]
    eng.run()
    return [r.tokens for r in out]


def test_per_row_forward_matches_shared_and_jax(setup):
    params, cfg_j, _, model, _, _ = setup
    tc = cfg_j.text_config
    ad, scale = random_adapter(cfg_j, r=2, seed=7)
    x = np.random.RandomState(1).randn(2, 3, tc.hidden_size).astype(np.float32) * 0.1
    pos = np.broadcast_to(np.arange(3, dtype=np.int32)[None], (2, 3))
    per_row = {n: {"a": np.stack([m["a"], np.zeros_like(m["a"])], 1),
                   "b": np.stack([m["b"] * scale, np.zeros_like(m["b"])], 1)} for n, m in ad["layers"].items()}
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    h_rows, _ = gemma.forward(model.llm, tx, tpos, lora=lora_from_jax(per_row, device="cpu"))
    h_x, _ = gemma.forward(model.llm, tx[:1], tpos[:1], lora=lora_from_jax(ad, device="cpu"), lora_scale=scale)
    h_none, _ = gemma.forward(model.llm, tx[1:], tpos[1:])
    np.testing.assert_allclose(h_rows[0].numpy(), h_x[0].numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h_rows[1].numpy(), h_none[0].numpy(), rtol=2e-5, atol=2e-5)
    ref, _ = jgemma.forward(params["llm"], tc, jnp.asarray(x), jnp.asarray(pos),
                            lora=jax.tree_util.tree_map(jnp.asarray, per_row))
    np.testing.assert_allclose(h_rows.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_adapters_match_jax_isolation_and_base(setup, spec_k):
    """Two adapters (ranks 2 and 3 at engine rank 4) and a base request in
    3 slots: the JAX engine's tokens; each adapted request alone gives its
    tokens beside the others; the base request the base engine's."""
    cfg_j = setup[1]
    ad1, s1 = random_adapter(cfg_j, r=2, seed=21, scale_b=0.8)
    ad2, s2 = random_adapter(cfg_j, r=3, seed=22, scale_b=0.8)
    adapters = [("a1", ad1, s1), ("a2", ad2, s2)]
    reqs = [(0, "a1"), (1, "a2"), (2, None)]
    kw = dict(n_slots=3, lora_rank=4, adapters=adapters, spec_k=spec_k)
    together = port_tokens(setup, reqs, **kw)
    assert together == jax_tokens(setup, reqs, **kw)
    assert together[0] == port_tokens(setup, [(0, "a1")], **kw)[0]
    assert together[1] == port_tokens(setup, [(1, "a2")], **kw)[0]
    base = port_tokens(setup, [(i, None) for i in range(3)], n_slots=3, spec_k=spec_k)
    assert together[2] == base[2]
    assert together[:2] != base[:2]  # the adapters steer decoding


def test_adapter_reuse_after_eviction(setup):
    """One slot: an adapted request, then a base request in the same slot,
    which must not see the adapter (the join writes the zero adapter)."""
    cfg_j = setup[1]
    ad, scale = random_adapter(cfg_j, r=2, seed=31, scale_b=0.8)
    kw = dict(n_slots=1, max_new=5, lora_rank=2, adapters=[("fin", ad, scale)])
    got = port_tokens(setup, [(0, "fin"), (1, None)], **kw)
    assert got == jax_tokens(setup, [(0, "fin"), (1, None)], **kw)
    assert got[1] == port_tokens(setup, [(1, None)], n_slots=1, max_new=5)[0]


def test_adapters_compose_with_int8_base(setup):
    params, cfg_j = setup[0], setup[1]
    qmodel = quantization.quantize_params(setup[3], llm_only=True)
    qparams = j_quantize_params(params, llm_only=True)
    ad, scale = random_adapter(cfg_j, r=2, seed=51, scale_b=0.9)
    kw = dict(lora_rank=2, adapters=[("fin", ad, scale)])
    together = port_tokens(setup, [(0, None), (1, "fin")], model=qmodel, **kw)
    assert together == jax_tokens(setup, [(0, None), (1, "fin")], params=qparams, **kw)
    base = port_tokens(setup, [(0, None), (1, None)], model=qmodel)
    assert together[0] == base[0] and together[1] != base[1]


def test_prefix_cache_keys_on_the_adapter(setup):
    """The same prompt and image, base then adapted then base, through a
    1-slot engine with a prefix cache: the adapted request misses (its own
    key) and gives the tokens it gives without the cache."""
    cfg_j = setup[1]
    ad, scale = random_adapter(cfg_j, r=2, seed=61, scale_b=0.8)
    kw = dict(n_slots=1, lora_rank=2, adapters=[("fin", ad, scale)])
    _, _, _, model, pt, images = setup
    eng = ContinuousBatcher(model, pt, n_slots=1, max_new_tokens=6, chunk=2, lora_rank=2, prefill_cache_size=4)
    eng.register_adapter("fin", lora_from_jax(ad, device="cpu"), scale)
    reqs = [eng.submit(PROMPTS[0], images[0], adapter=a) for a in (None, "fin", None, "fin")]
    eng.run()
    eng.close()
    assert eng.prefill_cache_hits == 2
    ref = port_tokens(setup, [(0, None), (0, "fin")], **kw)
    assert [r.tokens for r in reqs] == ref + ref


def test_refusals_and_rank_padding(setup):
    cfg_j, model, pt, images = setup[1], setup[3], setup[4], setup[5]
    ad_big, s_big = random_adapter(cfg_j, r=8, seed=41)
    eng = ContinuousBatcher(model, pt, n_slots=1, max_new_tokens=4, lora_rank=4)
    with pytest.raises(ValueError, match="exceeds engine lora_rank"):
        eng.register_adapter("big", lora_from_jax(ad_big, device="cpu"), s_big)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(PROMPTS[0], images[0], adapter="nope")
    with pytest.raises(ValueError, match="exceeds the engine budget"):
        eng.submit(PROMPTS[0], images[0], max_new_tokens=99)
    eng.close()
    # Rank 2 padded to 4 gives rank 2's tokens (the padded channels add exact zeros).
    ad, scale = random_adapter(cfg_j, r=2, seed=43, scale_b=0.8)
    for_rank = [port_tokens(setup, [(0, "fin")], n_slots=1, lora_rank=r, adapters=[("fin", ad, scale)])
                for r in (2, 4)]
    assert for_rank[0] == for_rank[1]

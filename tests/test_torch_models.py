"""Models of the PyTorch port against the JAX package at ``tiny_config`` in fp32.

Weights are made by the JAX package and carried over by
``paligemma_tpu_torch.utils.convert``; the JAX side runs with its Pallas
attention route on (interpret mode on the CPU), unjitted, and the flag is
restored afterwards. Logits agree within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu import generation as jgen
from paligemma_tpu import runtime
from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.models import siglip as jsig
import paligemma_tpu_torch
from paligemma_tpu_torch import generation as tgen
from paligemma_tpu_torch.models import gemma as tgemma
from paligemma_tpu_torch.models import paligemma as tpg
from paligemma_tpu_torch.models import siglip as tsig
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.ops.kernels import PLAIN
from paligemma_tpu_torch.utils.convert import from_jax_params

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port model) on the same weights."""
    jcfg = j_tiny_config()
    jparams = jpg.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = paligemma_tpu_torch.tiny_config()
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, model


@pytest.fixture(scope="module")
def inputs(pair):
    jcfg = pair[0]
    rng = np.random.RandomState(7)
    n_img = jcfg.vision_config.num_image_tokens
    ids = np.concatenate(
        [np.full((1, n_img), jcfg.image_token_index, np.int32),
         rng.randint(2, 250, (1, 6)).astype(np.int32)], axis=1)
    size = jcfg.vision_config.image_size
    pix = rng.randn(1, 3, size, size).astype(np.float32)
    return ids, pix


def _pallas(fn):
    prev = runtime.use_pallas_attention
    runtime.set_pallas_attention(True)
    try:
        return fn()
    finally:
        runtime.set_pallas_attention(prev)


def _close(got, ref, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=tol)


def test_config_presets_match_jax():
    from dataclasses import asdict

    from paligemma_tpu import config as jconfig

    for name in ("paligemma_3b_pt_224", "paligemma_3b_pt_448", "paligemma_3b_pt_896", "tiny_config"):
        assert asdict(getattr(paligemma_tpu_torch, name)()) == asdict(getattr(jconfig, name)())
    raw = {"vision_config": {"hidden_size": 64, "image_size": 56, "patch_size": 14},
           "text_config": {"num_hidden_layers": 3}, "projection_dim": 64}
    assert asdict(paligemma_tpu_torch.PaliGemmaConfig.from_dict(raw)) == asdict(
        jconfig.PaliGemmaConfig.from_dict(raw))


def test_extract_patches_matches_jax():
    x = np.random.RandomState(8).randn(2, 3, 16, 24).astype(np.float32)
    np.testing.assert_array_equal(
        tsig.extract_patches(torch.from_numpy(x), 8).numpy(),
        np.asarray(jsig.extract_patches(jnp.asarray(x), 8)))


def test_siglip_apply_matches_jax(pair, inputs):
    jcfg, jparams, _, model = pair
    pix = inputs[1]
    ref = _pallas(lambda: jsig.apply(jparams["vision"], jcfg.vision_config, jnp.asarray(pix)))
    _close(tsig.apply(model.vision, torch.from_numpy(pix)), ref)


def test_encode_image_matches_jax(pair, inputs):
    jcfg, jparams, _, model = pair
    pix = inputs[1]
    ref = _pallas(lambda: jpg.encode_image(jparams, jcfg, jnp.asarray(pix)))
    _close(tpg.encode_image(model, torch.from_numpy(pix)), ref)


@pytest.mark.parametrize("full_logits", [True, False])
def test_prefill_and_decode_logits_match_jax(pair, inputs, full_logits):
    jcfg, jparams, _, model = pair
    ids, pix = inputs

    def jax_run():
        cache = jgen.make_cache(jcfg, 1, ids.shape[1], 3, jnp.float32)
        lg, cache = jpg.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pix), cache,
                                full_logits=full_logits)
        toks, steps = [jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]], []
        for _ in range(2):
            d, cache = jpg.decode_step(jparams, jcfg, toks[-1], cache)
            steps.append(d)
            toks.append(jnp.argmax(d[:, -1], -1).astype(jnp.int32)[:, None])
        return lg, toks, steps

    lg_j, toks_j, steps_j = _pallas(jax_run)
    cache = tgen.make_cache(model, 1, ids.shape[1], 3)
    lg_t, cache = tpg.prefill(model, torch.from_numpy(ids), torch.from_numpy(pix), cache,
                              full_logits=full_logits)
    assert lg_t.dtype == torch.float32 and lg_t.shape == lg_j.shape
    _close(lg_t, lg_j)
    for step, (tok, ref) in enumerate(zip(toks_j[:-1], steps_j)):
        d_t, cache = tpg.decode_step(model, torch.tensor(np.asarray(tok)), cache)
        _close(d_t, ref)
        assert cache.length == ids.shape[1] + step + 1
        assert cache.valid.tolist() == [cache.length]


def test_init_params_scheme_and_seed():
    cfg = paligemma_tpu_torch.tiny_config()
    a = tpg.init_params(cfg, 3, device="cpu")
    b = tpg.init_params(cfg, 3, device="cpu")
    c = tpg.init_params(cfg, 4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["llm.embed"], sc["llm.embed"])
    assert not any(p.requires_grad for p in a.parameters())
    layer = a.llm.layers[0]
    assert torch.all(layer.input_ln.weight == 0) and torch.all(a.llm.final_norm.weight == 0)
    assert torch.all(a.vision.layers[0].ln1.weight == 1) and torch.all(a.vision.layers[0].qkv.bias == 0)
    w = a.llm.layers[1].gate_up.weight  # N(0, 1/fan_in), fan_in = hidden
    assert abs(float(w.std()) * cfg.text_config.hidden_size**0.5 - 1.0) < 0.1
    # The port stores the (L, ...) stacks as per-layer nn.Linear (out, in).
    assert tuple(layer.qkv.weight.shape) == ((4 + 2 * 2) * 8, cfg.text_config.hidden_size)


def test_convert_carries_every_parameter(pair):
    jcfg, jparams, _, model = pair
    np.testing.assert_array_equal(
        model.llm.layers[1].o.weight.numpy(), np.asarray(jparams["llm"]["layers"]["o"][1]).T)
    np.testing.assert_array_equal(
        model.vision.layers[0].ln2.weight.numpy(),
        np.asarray(jparams["vision"]["layers"]["ln2"]["scale"][0]))
    assert len(model.state_dict()) == len(model.state_dict(keep_vars=True))


def test_prefill_needs_an_empty_cache_and_a_free_slot(pair, inputs):
    model = pair[3]
    ids, pix = map(torch.from_numpy, inputs)
    cache = tgen.make_cache(model, 1, ids.shape[1], 1)
    _, cache = tpg.prefill(model, ids, pix, cache)
    with pytest.raises(ValueError, match="empty cache"):
        tpg.prefill(model, ids, pix, cache)
    _, cache = tpg.decode_step(model, torch.tensor([[5]]), cache)
    with pytest.raises(ValueError, match="cache full"):
        tpg.decode_step(model, torch.tensor([[5]]), cache)


def test_model_functions_take_the_attention_functions_explicitly(pair, inputs):
    """``fns`` selects the kernel functions; on the CPU both routes are the
    plain versions and agree exactly."""
    model = pair[3]
    ids, pix = map(torch.from_numpy, inputs)
    calls = {"flash": 0, "decode": 0}

    def flash(*a, **k):
        calls["flash"] += 1
        return ca.flash_attention_plain(*a, **k)

    def decode(*a, **k):
        calls["decode"] += 1
        return ca.decode_attention_plain(*a, **k)

    cache = tgen.make_cache(model, 1, ids.shape[1], 2)
    fns = PLAIN._replace(flash=flash, decode=decode)
    lg, cache = tpg.prefill(model, ids, pix, cache, fns=fns)
    tpg.decode_step(model, torch.tensor([[7]]), cache, fns=fns)
    n_vis = model.cfg.vision_config.num_hidden_layers
    n_llm = model.cfg.text_config.num_hidden_layers
    assert calls == {"flash": n_vis + n_llm, "decode": n_llm}
    ref, _ = tpg.prefill(model, ids, pix, tgen.make_cache(model, 1, ids.shape[1], 2))
    assert torch.equal(lg, ref)


def test_kv_cache_layout():
    cfg = paligemma_tpu_torch.tiny_config().text_config
    cache = tgemma.init_cache(cfg, 2, 11, torch.float32, device="cpu")
    assert tuple(cache.k.shape) == (cfg.num_hidden_layers, 2, 11, cfg.num_key_value_heads, cfg.head_dim)
    assert cache.length == 0 and cache.max_len == 11 and cache.valid.dtype == torch.int32

"""Checkpoint loading of the PyTorch port against the JAX package's, on the CPU.

A tiny HF PaliGemma is saved with ``save_pretrained`` (the hub's key layout,
as ``tests/test_golden_parity.py`` builds it; nothing is downloaded). The
port's ``load_model`` must give the JAX ``load_model``'s weights exactly and
prefill logits within 1e-5 (fp32), streaming must give the whole load's
bits, both key styles must load, the port's safetensors reader and writer
must agree with the ``safetensors`` package on F32, BF16, F16, I8 and I32,
and ``save_params`` files must move between the packages both ways with
identical logits.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu import generation as jgen
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.utils import checkpoint as jck
from paligemma_tpu_torch import generation as tgen
from paligemma_tpu_torch import quantization
from paligemma_tpu_torch.models import paligemma as tpg
from paligemma_tpu_torch.utils import checkpoint as tck
from paligemma_tpu_torch.utils.convert import from_jax_params, state_dict_from_jax

transformers = pytest.importorskip("transformers")

GEOMETRIES = {
    "tiny": dict(
        vision=dict(hidden_size=24, intermediate_size=48, num_attention_heads=4,
                    num_hidden_layers=2, patch_size=8, image_size=32),
        text=dict(hidden_size=32, intermediate_size=64, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=8, num_hidden_layers=2, vocab_size=260),
        projection_dim=32,
    ),
    # paligemma-3b-pt-224's ratios scaled down: patch 14, non-128-aligned
    # SigLIP head_dim, Gemma GQA 4:1, 3 layers each.
    "medium": dict(
        vision=dict(hidden_size=72, intermediate_size=144, num_attention_heads=4,
                    num_hidden_layers=3, patch_size=14, image_size=56),
        text=dict(hidden_size=64, intermediate_size=256, num_attention_heads=4,
                  num_key_value_heads=1, head_dim=16, num_hidden_layers=3, vocab_size=1024),
        projection_dim=64,
    ),
}


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def hf_ckpt(request, tmp_path_factory):
    """(checkpoint dir, prefill ids, pixels) of a tiny HF PaliGemma."""
    from transformers import PaliGemmaConfig as HFPaliGemmaConfig
    from transformers import PaliGemmaForConditionalGeneration

    geo = GEOMETRIES[request.param]
    image_token = geo["text"]["vocab_size"] - 4
    hf_cfg = HFPaliGemmaConfig(
        vision_config=dict(projection_dim=geo["projection_dim"], **geo["vision"]),
        text_config=dict(max_position_embeddings=512, **geo["text"]),
        image_token_index=image_token, pad_token_id=0, projection_dim=geo["projection_dim"],
        hidden_size=geo["text"]["hidden_size"],
    )
    torch.manual_seed(0)
    model = PaliGemmaForConditionalGeneration(hf_cfg).eval()
    path = tmp_path_factory.mktemp(f"hf_{request.param}")
    model.save_pretrained(str(path), safe_serialization=True)

    n_img = (geo["vision"]["image_size"] // geo["vision"]["patch_size"]) ** 2
    rng = np.random.RandomState(0)
    ids = np.concatenate([np.full((1, n_img), image_token), rng.randint(2, image_token - 8, size=(1, 7))],
                         axis=1).astype(np.int32)
    size = geo["vision"]["image_size"]
    pix = rng.randn(1, 3, size, size).astype(np.float32)
    return str(path), ids, pix


def _jax_state_dict(params):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _prefill_logits(model, ids, pix):
    cache = tgen.make_cache(model, 1, ids.shape[1], 4)
    logits, _ = tpg.prefill(model, torch.from_numpy(ids), torch.from_numpy(pix), cache)
    return logits.numpy()


def test_load_model_gives_the_jax_weights_and_prefill_logits(hf_ckpt):
    path, ids, pix = hf_ckpt
    params, cfg_j = jck.load_model(path, dtype=jnp.float32)
    model, cfg = tck.load_model(path, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    want = _jax_state_dict(params)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[k]), err_msg=k)
    cache = jgen.make_cache(cfg_j, 1, ids.shape[1], 4, jnp.float32)
    ref, _ = jpg.prefill(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), cache)
    np.testing.assert_allclose(_prefill_logits(model, ids, pix), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_load_is_the_whole_load_bit_for_bit(hf_ckpt, dtype):
    path, _, _ = hf_ckpt
    whole, _ = tck.load_model(path, dtype=dtype, device="cpu")
    stream, _ = tck.load_model(path, dtype=dtype, streaming=True, device="cpu")
    a, b = whole.state_dict(), stream.state_dict()
    assert a.keys() == b.keys() and all(a[k].dtype == dtype and torch.equal(a[k], b[k]) for k in a)


def _new_style(key):
    """A hub (old-style) key as transformers' refactored models name it."""
    if key.startswith("language_model.model."):
        return "model.language_model." + key[len("language_model.model."):]
    if key.startswith("language_model.lm_head."):
        return key[len("language_model."):]
    return "model." + key


def test_new_style_keys_load_as_the_old_style(hf_ckpt, tmp_path):
    """The checkpoint rewritten with new-style keys (``model.language_model.*``)
    loads, whole and streaming, to the same model; the key map is the JAX
    package's."""
    path, _, _ = hf_ckpt
    flat = tck.load_safetensors_shards(path)
    assert not tck.hf_key_map(flat.keys())  # save_pretrained writes the hub's style
    new = {_new_style(k): v for k, v in flat.items()}
    assert tck.hf_key_map(new.keys()) == jck.hf_key_map(list(new.keys())) != {}
    assert tck.normalize_hf_keys(new).keys() == flat.keys()
    (tmp_path / "config.json").write_text(open(f"{path}/config.json").read())
    tck.save_file(new, str(tmp_path / "model.safetensors"))
    a = tck.load_model(path, dtype=torch.float32, device="cpu")[0].state_dict()
    for streaming in (False, True):
        b = tck.load_model(str(tmp_path), dtype=torch.float32, streaming=streaming, device="cpu")[0].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int32])
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        tensors = {"a": torch.randn(3, 5, generator=gen).to(dtype), "b": torch.randn(7, generator=gen).to(dtype)}
    else:
        tensors = {"a": torch.randint(-100, 100, (4, 3), generator=gen).to(dtype),
                   "b": torch.randint(-100, 100, (9,), generator=gen).to(dtype)}
    tensors["scalar"] = tensors["b"][0].clone()
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"))
    got = tck.load_file(str(tmp_path / "pkg.safetensors"))
    assert got.keys() == tensors.keys()
    assert all(got[k].dtype == dtype and got[k].shape == tensors[k].shape and torch.equal(got[k], tensors[k])
               for k in tensors)
    tck.save_file(tensors, str(tmp_path / "port.safetensors"))
    back = st.load_file(str(tmp_path / "port.safetensors"))
    assert all(back[k].dtype == dtype and torch.equal(back[k], tensors[k]) for k in tensors)


def test_an_unknown_dtype_raises(tmp_path):
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}).encode()
    path = tmp_path / "f8.safetensors"
    path.write_bytes(np.array([len(header)], "<u8").tobytes() + header + b"\0\0")
    with pytest.raises(ValueError, match="F8_E4M3"):
        tck.load_file(str(path))


@pytest.fixture(scope="module")
def tiny_jax():
    from paligemma_tpu.config import tiny_config

    cfg_j = tiny_config()
    params = jpg.init_params(cfg_j, jax.random.PRNGKey(3), jnp.float32)
    import paligemma_tpu_torch

    cfg_t = paligemma_tpu_torch.tiny_config()
    rng = np.random.RandomState(1)
    n_img = cfg_t.vision_config.num_image_tokens
    ids = np.concatenate([np.full((1, n_img), cfg_t.image_token_index), rng.randint(2, 250, (1, 6))],
                         axis=1).astype(np.int32)
    pix = rng.randn(1, 3, 32, 32).astype(np.float32)
    return cfg_j, params, cfg_t, ids, pix


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_save_params_file_loads_in_the_port(tiny_jax, tmp_path, bf16):
    cfg_j, params, cfg_t, ids, pix = tiny_jax
    if bf16:
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    path = str(tmp_path / "params.safetensors")
    jck.save_params(params, path)
    model = tck.load_params(path, cfg_t, device="cpu")
    want = from_jax_params(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params), cfg_t,
                           device="cpu", dtype=torch.bfloat16 if bf16 else torch.float32)
    got, ref = model.state_dict(), want.state_dict()
    assert all(got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]) for k in ref)
    if not bf16:
        np.testing.assert_array_equal(_prefill_logits(model, ids, pix), _prefill_logits(want, ids, pix))


@pytest.mark.parametrize("bf16", [False, True])
def test_port_save_params_file_loads_in_jax(tiny_jax, tmp_path, bf16):
    cfg_j, params, cfg_t, ids, pix = tiny_jax
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu",
                            dtype=torch.bfloat16 if bf16 else torch.float32)
    path = str(tmp_path / "params.safetensors")
    tck.save_params(model, path)
    loaded = jck.load_params(path)
    want = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params) if bf16 else params
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    if not bf16:
        cache = jgen.make_cache(cfg_j, 1, ids.shape[1], 4, jnp.float32)
        got, _ = jpg.prefill(loaded, cfg_j, jnp.asarray(ids), jnp.asarray(pix), cache)
        cache = jgen.make_cache(cfg_j, 1, ids.shape[1], 4, jnp.float32)
        ref, _ = jpg.prefill(params, cfg_j, jnp.asarray(ids), jnp.asarray(pix), cache)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_save_params_refuses_quantized_modules(tiny_jax, tmp_path):
    _, params, cfg_t, _, _ = tiny_jax
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    with pytest.raises(TypeError, match="re-quantize after load"):
        tck.save_params(quantization.quantize_params(model), str(tmp_path / "q.safetensors"))


def test_port_hf_writer_round_trips_through_both_loaders(hf_ckpt, tmp_path):
    """``save_hf_checkpoint`` writes shards and a config.json that the JAX
    loader and the port's read back to the original weights and config."""
    path, _, _ = hf_ckpt
    model, cfg = tck.load_model(path, dtype=torch.float32, device="cpu")
    tck.save_hf_checkpoint(model, str(tmp_path), max_shard_bytes=20_000)
    assert len(list(tmp_path.glob("*.safetensors"))) > 1
    again, cfg2 = tck.load_model(str(tmp_path), dtype=torch.float32, device="cpu")
    assert cfg2 == cfg
    a, b = model.state_dict(), again.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    p1, _ = jck.load_model(path, dtype=jnp.float32)
    p2, _ = jck.load_model(str(tmp_path), dtype=jnp.float32)
    assert all(np.array_equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)))

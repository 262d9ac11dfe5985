"""``models/paligemma.py::merge_general`` of the port against the JAX
package's on the same weights and numpy-seeded image features, fp32 at
1e-6 (each output element is one embedding row or one feature, copied:
the only arithmetic is the cast to the embedding's dtype)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.config import tiny_config as j_tiny_config
from paligemma_tpu.models import paligemma as jpg
import paligemma_tpu_torch
from paligemma_tpu_torch.models import paligemma as tpg
from paligemma_tpu_torch.utils.convert import from_jax_params

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny_config()
    jparams = jpg.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), paligemma_tpu_torch.tiny_config(),
                            device="cpu")
    return jcfg, jparams, model


def _features(jcfg, b, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(b, jcfg.vision_config.num_image_tokens, jcfg.text_config.hidden_size).astype(np.float32)


def _ids(jcfg, layout):
    """(2, T) ids of one layout: the templated prefix, image tokens among
    text, or the prefix with pad ids in the text."""
    rng = np.random.RandomState(5)
    n_img, img = jcfg.vision_config.num_image_tokens, jcfg.image_token_index
    if layout == "prefix":
        return np.concatenate([np.full((2, n_img), img, np.int32), rng.randint(2, 250, (2, 6)).astype(np.int32)],
                              axis=1)
    if layout == "scattered":
        ids = rng.randint(2, 250, (2, n_img + 9)).astype(np.int32)
        for row in range(2):
            ids[row, np.sort(rng.choice(n_img + 9, n_img, replace=False))] = img
        return ids
    ids = _ids(jcfg, "prefix")
    ids[0, -3:] = jcfg.pad_token_id
    ids[1, n_img + 1] = jcfg.pad_token_id
    return ids


@pytest.mark.parametrize("layout", ["prefix", "scattered", "pad"])
def test_merge_general_matches_jax(pair, layout):
    jcfg, jparams, model = pair
    ids, feats = _ids(jcfg, layout), _features(jcfg, 2, 3)
    want = np.asarray(jpg.merge_general(jparams, jcfg, jnp.asarray(ids), jnp.asarray(feats)))
    got = tpg.merge_general(model, torch.from_numpy(ids), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    is_pad = ids == jcfg.pad_token_id
    assert (got.numpy()[is_pad] == 0).all()
    if layout == "prefix":  # the templated layout: the concat of merge_prefix
        np.testing.assert_allclose(got.numpy(), tpg.merge_prefix(model, torch.from_numpy(ids),
                                                                 torch.from_numpy(feats)).numpy(), **TOL)
    if layout == "scattered":  # the i-th image position holds the i-th feature
        for row in range(2):
            np.testing.assert_array_equal(got.numpy()[row, ids[row] == jcfg.image_token_index], feats[row])

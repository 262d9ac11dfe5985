"""The processor's on-device paths in the PyTorch port
(``paligemma_tpu_torch/processing.py``) against the JAX package's, on the
CPU: ``pixel_lut`` and ``pixel_affine_coeffs`` bit for bit; the gather
(``apply_pixel_lut``) and the affine (``apply_pixel_affine``) bit for bit
in fp32 and bf16, with the same ramp gate decision; the ``raw_uint8``
processor output equal to JAX's, and through the gather equal to the host
pipeline; ``preprocess`` (``preprocess_jit``'s counterpart) within 5e-5 of
JAX's ``jax.image.resize`` bicubic (measured: at most 2.1e-05 over these
shapes, fp32 summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from paligemma_tpu import processing as jp
from paligemma_tpu_torch import processing as tp

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 256, (20 + 7 * i, 28 + 5 * i, 3), np.uint8)) for i in range(n)]


def test_tables_equal_jax():
    np.testing.assert_array_equal(tp.pixel_lut(), jp.pixel_lut())
    for got, want in zip(tp.pixel_affine_coeffs(), jp.pixel_affine_coeffs()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
def test_gather_and_affine_bit_for_bit(dt):
    jd, td = dt
    pix = np.random.RandomState(1).randint(0, 256, (2, 3, 16, 24)).astype(np.uint8)
    lut = jp.pixel_lut()
    want = np.asarray(jp.apply_pixel_lut(jnp.asarray(lut, jd), jnp.asarray(pix)).astype(jnp.float32))
    got = tp.apply_pixel_lut(torch.from_numpy(lut).to(td), torch.from_numpy(pix))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), want)
    c, m = jp.pixel_affine_coeffs()
    want = np.asarray(jp.apply_pixel_affine(jnp.asarray(c), jnp.asarray(m), jnp.asarray(pix), jd).astype(jnp.float32))
    got = tp.apply_pixel_affine(torch.from_numpy(c), torch.from_numpy(m), torch.from_numpy(pix), td)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # The ramp gate decides as JAX's does (fp32: one ulp apart; bf16: equal).
    ramp_j = jnp.broadcast_to(jnp.arange(256, dtype=jnp.uint8)[None, None, None, :], (1, 3, 1, 256))
    ramp_t = torch.arange(256, dtype=torch.uint8)[None, None, None, :].expand(1, 3, 1, 256)
    gate_j = bool(jnp.all(jp.apply_pixel_lut(jnp.asarray(lut, jd), ramp_j)
                          == jp.apply_pixel_affine(jnp.asarray(c), jnp.asarray(m), ramp_j, jd)))
    gate_t = torch.equal(tp.apply_pixel_lut(torch.from_numpy(lut).to(td), ramp_t),
                         tp.apply_pixel_affine(torch.from_numpy(c), torch.from_numpy(m), ramp_t, td))
    assert gate_t == gate_j == (td == torch.bfloat16)


def test_raw_uint8_processor_equals_jax_and_the_host_pipeline():
    images = _images(3)
    prompts = ["a", "describe the chart", "mid"]
    jproc = jp.PaliGemmaProcessor(jp.ByteTokenizer(), 16, 32)
    tproc = tp.PaliGemmaProcessor(tp.ByteTokenizer(), 16, 32)
    want = jproc(text=prompts, images=images, raw_uint8=True)
    got = tproc(text=prompts, images=images, raw_uint8=True)
    assert got["pixel_values"].dtype == np.uint8 and got["pixel_values"].shape == (3, 3, 32, 32)
    for key in ("pixel_values", "input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    host = tproc(text=prompts, images=images)["pixel_values"]
    via_lut = tp.apply_pixel_lut(torch.from_numpy(tp.pixel_lut()), torch.from_numpy(got["pixel_values"]))
    np.testing.assert_array_equal(via_lut.numpy(), host)
    for g, w in zip(tp.process_images_uint8(images, (32, 32)), jp.process_images_uint8(images, (32, 32))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,size", [((2, 20, 28, 3), (16, 16)), ((1, 300, 200, 3), (224, 224)),
                                        ((1, 10, 12, 3), (32, 32)), ((3, 64, 64, 3), (64, 32))])
def test_preprocess_matches_preprocess_jit(shape, size):
    raw = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(jp.preprocess_jit(jnp.asarray(raw), *size))
    got = tp.preprocess(torch.from_numpy(raw), *size)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)

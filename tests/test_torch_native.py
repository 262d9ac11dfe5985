"""The port's native preprocessor (``paligemma_tpu_torch/native.py``)
against the JAX package's binding of the same source and against the port's
PIL host pipeline.

- Bit for bit ``paligemma_tpu.native.preprocess_images_native`` on the same
  uint8 inputs: one source, one compiler, one set of flags.
- Within ``tests/test_native.py``'s bars of ``processing.process_images``:
  at most 2.5 / 255 (+1e-6) per pixel and a mean below 0.5 / 255 (PIL runs
  the same cubic in 8-bit fixed point: one quantization step of slack).
"""
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from paligemma_tpu import native as jnative
from paligemma_tpu_torch import native
from paligemma_tpu_torch.processing import process_images

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the native preprocessor")

SIZES = [(64, 48), (224, 224), (480, 640)]


def _raw(shape, seed):
    return np.random.RandomState(seed).randint(0, 255, shape, np.uint8)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_native_matches_jax_bit_for_bit(hw):
    raw = _raw((2, *hw, 3), 0)
    got = native.preprocess_images_native(raw, 32)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jnative.preprocess_images_native(raw, 32))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_native_matches_the_pil_pipeline(hw):
    raw = _raw((*hw, 3), 0)
    host = process_images([Image.fromarray(raw)], size=(32, 32))[0]
    nat = native.preprocess_images_native(raw[None], 32)[0].numpy()
    assert nat.shape == host.shape == (3, 32, 32)
    diff = np.abs(nat - host)
    assert diff.max() <= 2.5 / 255.0 + 1e-6, diff.max()
    assert np.mean(diff) < 0.5 / 255.0


def test_native_batch_equals_single_calls():
    assert native.available()
    raw = _raw((4, 100, 80, 3), 1)
    out = native.preprocess_images_native(raw, 16)
    assert out.shape == (4, 3, 16, 16)
    for i in range(4):
        torch.testing.assert_close(out[i], native.preprocess_images_native(raw[i], 16)[0], rtol=0, atol=0)


def test_native_refuses_rgba():
    with pytest.raises(ValueError, match="4 channels"):
        native.preprocess_images_native(_raw((1, 8, 8, 4), 2), 8)


def test_native_builds_outside_the_source_directory(tmp_path, monkeypatch):
    """The build writes only under the build directory, keyed by the
    source's hash: nothing lands beside the source (``native/`` holds the
    JAX module's own build)."""
    src_dir = tmp_path / "native"
    src_dir.mkdir()
    shutil.copy(native.SOURCE, src_dir / "preproc.cpp")
    monkeypatch.setattr(native, "SOURCE", src_dir / "preproc.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        out = native.preprocess_images_native(np.zeros((8, 8, 3), np.uint8), 8)
        lib = native.library_path()
    finally:
        native.load.cache_clear()
    torch.testing.assert_close(out, torch.full((1, 3, 8, 8), -1.0), rtol=0, atol=0)
    assert sorted(p.name for p in src_dir.iterdir()) == ["preproc.cpp"]
    assert lib.exists() and lib.parent.parent == tmp_path / "build"
    assert [p.name for p in lib.parent.iterdir()] == ["libpreproc.so"]

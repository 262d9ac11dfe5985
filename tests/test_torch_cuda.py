"""The port's CUDA kernels on the card (marker ``gpu``; skipped without one).

    python -m pytest -m gpu tests/test_torch_cuda.py

Each kernel is held to its plain version on the same bf16 inputs (two bf16
ulps, see chip_smoke.py), and a tiny model's kernel path to its plain path.
"""
import dataclasses

import pytest
import torch

import paligemma_tpu_torch
from paligemma_tpu_torch import generation
from paligemma_tpu_torch.models import paligemma
from paligemma_tpu_torch.ops import cuda_attention as ca

pytestmark = pytest.mark.gpu
RTOL, ATOL = 2.0**-7, 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("b,t,h,hkv,d,valid", [
    (1, 256, 16, 16, 72, None),
    (1, 100, 8, 1, 256, [61]),
    (2, 77, 4, 2, 64, [77, 20]),
])
def test_flash_kernel_matches_plain(cuda, b, t, h, hkv, d, valid):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _rand(gen, (b, t, h, d), cuda), _rand(gen, (b, t, hkv, d), cuda), _rand(gen, (b, t, hkv, d), cuda)
    vl = None if valid is None else torch.tensor(valid, dtype=torch.int32, device=cuda)
    before = ca.launch_counts()["flash_attention"]
    out = ca.flash_attention(q, k, v, vl, gen_start=t - 5, gen_end=t - 2)
    torch.cuda.synchronize()
    assert ca.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(out, ca.flash_attention_plain(q, k, v, vl, gen_start=t - 5, gen_end=t - 2),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,s,h,hkv,d,valid", [
    (1, 1100, 8, 1, 256, [700]),
    (2, 300, 4, 2, 72, [300, 33]),
])
def test_decode_kernel_matches_plain(cuda, b, s, h, hkv, d, valid):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _rand(gen, (b, 1, h, d), cuda)
    kc, vc = _rand(gen, (2, b, s, hkv, d), cuda)[1], _rand(gen, (2, b, s, hkv, d), cuda)[1]
    vl = torch.tensor(valid, dtype=torch.int32, device=cuda)
    out = ca.decode_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ca.decode_attention_plain(q, kc, vc, vl), rtol=RTOL, atol=ATOL)


def test_kernels_refuse_fp32(cuda):
    x = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        ca.flash_attention(x, x, x)


def test_tiny_model_kernel_path_matches_plain_path(cuda):
    cfg = paligemma_tpu_torch.tiny_config()
    # The kernels take head_dim in multiples of 8: widen tiny SigLIP's 6 to 8.
    cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
        cfg.vision_config, hidden_size=32, intermediate_size=64))
    model = paligemma.init_params(cfg, 0, device=cuda, dtype=torch.bfloat16)
    n_img = cfg.vision_config.num_image_tokens
    ids = torch.cat([torch.full((1, n_img), cfg.image_token_index), torch.arange(2, 9)[None]], 1).to(cuda)
    pix = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(cuda, torch.bfloat16)
    got, _ = generation.generate(model, ids, pix, 6, -1)
    want, _ = generation.generate(model, ids, pix, 6, -1, attn=ca.PLAIN)
    assert got[0] == want[0]

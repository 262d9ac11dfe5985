"""The plain reference against the port's CPU path at tiny widths, with 4
query heads a kv head at head_dim 128 and with 1 at head_dim 96: the same
ids and pixels from the same request, the prefill's logits at every prompt
position and three decode steps' logits through the cache, in float32 and
with the port's int8 weights against the reference's own.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from harness import serve, traffic, weights
from reference import vlm

LAYOUTS = ["gqa4", "mha96"]


def _config(layout: str, fmt: str) -> dict:
    cell = tiny.tiny_cell("mistral7b-int8.docqa-open", layout, fmt)
    return cell.config


def _request(seed: int):
    mix = {"output": {"dist": "uniform", "min": 4, "max": 4}, "prompt_bytes": [8, 48], "image_px": [20, 60]}
    spec = traffic.make_specs(mix, seed, 1)[0]
    return spec, traffic.image(traffic.noise_pool(seed), spec)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_inputs_match_the_port_processor(layout):
    config = _config(layout, "bf16")
    W = weights.make_weights(config, 3, "cpu", torch.float32)
    model, proc = serve.build_model(config, W)
    spec, img = _request(4)
    out = proc(text=[spec.prompt], images=[img])
    n_img = model.cfg.vision_config.num_image_tokens
    np.testing.assert_array_equal(out["input_ids"][0], vlm.token_ids(spec.prompt, n_img))
    np.testing.assert_array_equal(out["pixel_values"][0], vlm.pixels(img, config["vision"]["image_size"]).numpy())


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_reference_matches_the_port(layout, fmt):
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.ops.kernels import PLAIN

    config = _config(layout, fmt)
    W = weights.make_weights(config, 11, "cpu", torch.float32)
    model, proc = serve.build_model(config, dict(W))
    spec, img = _request(12)
    out = proc(text=[spec.prompt], images=[img])
    ids = torch.from_numpy(out["input_ids"]).long()
    pix = torch.from_numpy(out["pixel_values"])
    p = ids.shape[1]
    cache = gemma.init_cache(model.cfg.text_config, 1, p + 8, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = paligemma.prefill(model, ids, pix, cache, fns=PLAIN)
        port = [logits[0]]
        toks = [int(logits[0, -1].argmax())]
        for _ in range(3):
            step, cache = paligemma.decode_step(model, torch.tensor([[toks[-1]]]), cache, fns=PLAIN)
            port.append(step[0])
            toks.append(int(step[0, -1].argmax()))
    port_logits = torch.cat(port)  # every prompt position, then the three steps
    ref = vlm.Reference(W, config["vision"], config["text"], fmt)
    seq = np.concatenate([out["input_ids"][0], toks[:3]]).astype(np.int64)
    with torch.no_grad(), vlm.no_tf32():
        ref_logits = ref.logits([(pix[0], seq, p)])[0]
    scale = ref_logits.abs().max()
    # An int8 embedding makes the port's trunk bf16 (its lookup is bf16):
    # bf16 rounding, against float32's in the float model.
    tol = 2e-2 if fmt == "int8" else 2e-5
    assert float((port_logits - ref_logits).abs().max() / scale) < tol
    # The served tokens' gap is nought where the two agree.
    served = np.array(toks)
    ref_served = ref.served_logits([(pix[0], out["input_ids"][0].astype(np.int64), served)])[0]
    assert float(vlm.gaps(ref_served, torch.as_tensor(served)).max()) < 1e-4


@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_weights_match_the_port_quantization(layout):
    from paligemma_tpu_torch.quantization import dequantize

    config = _config(layout, "int8")
    W = weights.make_weights(config, 5, "cpu", torch.float32)
    model, _ = serve.build_model(config, dict(W))
    pairs = [(model.llm.embed, W["llm.embed"])]
    for i, layer in enumerate(model.llm.layers):
        pairs += [(getattr(layer, n), W[f"llm.layers.{i}.{n}.weight"]) for n in ("qkv", "o", "gate_up", "down")]
    for q, w in pairs:
        mine = vlm.WEIGHT_FORMATS["int8"](w)
        assert float((dequantize(q) - mine).abs().max()) <= 1e-6 * float(w.abs().max())


def test_weight_formats():
    w = torch.randn(16, 64)
    for fmt, levels in (("int8", 255), ("int4", 15)):
        q = vlm.WEIGHT_FORMATS[fmt](w)
        for row, qrow in zip(w, q):
            assert len(torch.unique(qrow)) <= levels
            assert float((qrow - row).abs().max()) <= float(row.abs().max()) / (levels - 1) + 1e-6
    f8 = vlm.WEIGHT_FORMATS["fp8"](w)
    assert float(((f8 - w).abs() / w.abs().amax(1, keepdim=True)).max()) < 0.07
    assert torch.equal(vlm.WEIGHT_FORMATS["bf16"](w), w)

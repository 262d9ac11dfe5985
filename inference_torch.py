"""The inference CLI of the PyTorch port (``paligemma_tpu_torch``), the
counterpart of ``inference.py``.

    python3 inference_torch.py --model_path DIR --prompt "caption en" --image_file_path IMG
    python3 inference_torch.py --demo --only_cpu=True --prompt "describe" --image_file_path IMG

The same flags and defaults as ``inference.py`` (model_path, prompt,
image_file_path, max_tokens_to_generate=100, temperature=0.8, top_p=0.9,
do_sample=False, only_cpu=False, ``--quant none|int8|w4a8``,
``--prefill_a8``, ``--speculative``), plus ``--demo``, which runs the
pipeline on a tiny randomly initialized model with the byte tokenizer when
no checkpoint is at hand. It runs on the CUDA card; ``--only_cpu=True`` is
the only way onto the CPU, and without it the CLI fails when there is no
card. Generation goes through ``generation.generate_chunked``, or with
``--speculative`` through ``generation.generate_spec`` (n-gram drafts, k =
8 tokens a verify step).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def build_processor(tokenizer, cfg):
    from paligemma_tpu_torch.processing import PaliGemmaProcessor

    return PaliGemmaProcessor(
        tokenizer,
        num_image_tokens=cfg.vision_config.num_image_tokens,
        image_size=cfg.vision_config.image_size,
    )


def test_inference(
    model,
    processor,
    prompt: str,
    image_file_path: str,
    max_tokens_to_generate: int,
    temperature: float,
    top_p: float,
    do_sample: bool,
    cache_dtype=None,
    seed: int = 0,
    speculative: bool = False,
):
    """Greedy or top-p generation (reference: inference.py:34-85); returns
    ``prompt + decoded`` as the reference does. Sampling draws from a
    generator seeded with ``seed`` on the model's device. ``speculative``:
    n-gram speculative decoding (greedy: the same tokens; sampled: the
    same distribution)."""
    import torch
    from PIL import Image

    from paligemma_tpu_torch import generation
    from paligemma_tpu_torch.processing import assert_aligned

    assert_aligned(processor, model.cfg)  # tokenizer/config contract, fail loudly
    dev = model.llm.final_norm.weight.device
    image = Image.open(image_file_path).convert("RGB")
    inputs = processor(text=[prompt], images=[image])
    ids = torch.from_numpy(inputs["input_ids"]).to(dev)
    pix = torch.from_numpy(inputs["pixel_values"]).to(dev, model.vision.patch_embedding.weight.dtype)
    generate = generation.generate_spec if speculative else generation.generate_chunked
    tokens = generate(
        model, ids, pix, max_tokens_to_generate, processor.tokenizer.eos_token_id,
        cache_dtype=cache_dtype, do_sample=do_sample, temperature=temperature, top_p=top_p,
        generator=torch.Generator(device=dev).manual_seed(seed),
    )
    decoded = processor.tokenizer.decode(tokens, skip_special_tokens=True)
    return prompt + decoded


def load_for_cli(model_path, demo: bool, quant: str = "none", prefill_a8: bool = False,
                 device: str = "cuda"):
    """Load (model, processor) on ``device``. ``quant="int8"``: the decoder
    weight-only int8 (the serving config); ``"w4a8"``: int4 MLP weights with
    int8 activations; ``prefill_a8``: int8 x int8 products for long calls.
    ``--demo`` (or no ``model_path``): the tiny config with random weights
    and the byte tokenizer, fp32 on the CPU; on the card bf16, with the
    SigLIP width raised from 24 to 32 (the kernels take bf16 and head_dim in
    multiples of 8)."""
    import torch

    from paligemma_tpu_torch import quantization

    def maybe_quant(model):
        if quant in ("int8", "w4a8"):
            return quantization.quantize_params(model, llm_only=True, mode=quant, prefill_a8=prefill_a8)
        if quant not in (None, "none"):
            raise ValueError(f"unknown quant mode {quant!r}")
        return model

    if demo or not model_path:
        from paligemma_tpu_torch.config import tiny_config
        from paligemma_tpu_torch.models import paligemma
        from paligemma_tpu_torch.processing import ByteTokenizer, align_config

        cfg = tiny_config()
        if device != "cpu":  # the kernels take head_dim in multiples of 8: tiny SigLIP's 6 becomes 8
            cfg = dataclasses.replace(cfg, vision_config=dataclasses.replace(
                cfg.vision_config, hidden_size=32, intermediate_size=64))
        processor = build_processor(ByteTokenizer(), cfg)
        cfg = align_config(cfg, processor)  # image id + both vocab sizes
        dtype = torch.float32 if device == "cpu" else torch.bfloat16
        model = paligemma.init_params(cfg, 0, device=device, dtype=dtype)
        return maybe_quant(model), processor

    from paligemma_tpu_torch.utils.checkpoint import load_model

    model, cfg = load_model(model_path, dtype=torch.bfloat16, device=device)
    model = maybe_quant(model)
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path, padding_side="right")
    except Exception as e:
        raise RuntimeError(
            f"could not load tokenizer from {model_path}: {e!r}. "
            "Pass --demo to run without a checkpoint."
        )
    return model, build_processor(tokenizer, cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--image_file_path", type=str, default=None)
    p.add_argument("--max_tokens_to_generate", type=int, default=100)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--do_sample", type=str2bool, default=False)
    p.add_argument("--only_cpu", type=str2bool, default=False)
    p.add_argument("--demo", action="store_true", help="tiny random model + byte tokenizer")
    p.add_argument("--quant", choices=["none", "int8", "w4a8"], default="none",
                   help="int8: weight-only quantized decoder (the serving config); w4a8: int4 MLP "
                        "weights + int8 activations")
    p.add_argument("--prefill_a8", type=str2bool, default=False,
                   help="int8 x int8 products for the long (prefill) projections (requires "
                        "--quant int8 or w4a8; not token-identical to bf16)")
    p.add_argument("--speculative", action="store_true",
                   help="n-gram speculative decoding: greedy output is token-identical, sampled "
                        "output draws the plain sampling distribution; faster when the answer "
                        "repeats context")
    args = p.parse_args(argv)

    import torch

    if args.prefill_a8 and args.quant not in ("int8", "w4a8"):
        print("error: --prefill_a8 requires --quant int8 or w4a8", file=sys.stderr)
        return 2
    if not args.only_cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --only_cpu=True to run on the CPU", file=sys.stderr)
        return 1
    device = "cpu" if args.only_cpu else "cuda"
    print("Device in use: ", torch.device(device) if args.only_cpu else torch.device(device, torch.cuda.current_device()))

    print("Loading model")
    model, processor = load_for_cli(args.model_path, args.demo, args.quant, args.prefill_a8, device)

    if args.prompt is None or args.image_file_path is None:
        print("error: --prompt and --image_file_path are required", file=sys.stderr)
        return 2

    print("Running inference")
    print(
        test_inference(
            model,
            processor,
            args.prompt,
            args.image_file_path,
            args.max_tokens_to_generate,
            args.temperature,
            args.top_p,
            args.do_sample,
            speculative=args.speculative,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-command real-checkpoint validation harness of the PyTorch port, the
counterpart of ``scripts/validate_checkpoint.py``:

    python3 scripts/validate_checkpoint_torch.py MODEL_DIR [--out report.json] [--only_cpu]

The same checks in the same order, with the same bars and report keys, each
recorded pass / fail / skipped in the JSON report (exit 0 iff no check
failed):

  config         config.json -> PaliGemmaConfig (geometry echoed)
  tokenizer      AutoTokenizer.from_pretrained + PaliGemmaProcessor token
                 registration (<image>, 1024 loc, 128 seg) + assert_aligned;
                 given a processor (``run_checks(processor=...)``), that
                 processor held to the config instead ("source": "given")
  load           utils/checkpoint.load_model onto the device (streaming for
                 checkpoints over 2 GB; host peak-RSS delta recorded)
  logit_parity   prefill logits vs HF transformers in fp32 at 1e-3 plus
                 greedy 8-token identity, both sides fp32 on the CPU (the
                 card's kernels take bf16). Skipped above --max_hf_mb unless
                 --hf on, or when transformers is absent.
  int8_identity  greedy tokens identical between the loaded model and its
                 int8 weight-only copy (the serving-config criterion)
  w4a8_agreement greedy agreement of w4a8 (qkv/o int8, the MLP int4 with
                 int8 activations) with the loaded model: at least 0.9
  lm_head_w4_agreement  the same with the 4-bit tied lm_head on top: at
                 least 0.9
  a8_prefill_agreement  greedy agreement of the int8 x int8 prefill with
                 plain int8: recorded, not gated
  lora_smoke     one ``lora.make_train_step`` step on the prompt: a finite
                 loss and an adapter that moved

A failed token check records the two streams and their first difference
beside its error.

The device is the CUDA card in bf16; ``--only_cpu`` runs on the CPU in fp32,
and without it the script exits 1 where there is no card.
``--selftest {tiny,flagship-ratios}`` needs no checkpoint: it synthesizes
one with HF ``save_pretrained`` and a real fast tokenizer at the JAX
script's geometries and validates it (HF parity forced on). ``--selftest``
and ``logit_parity`` need ``transformers`` (and ``tokenizers``); a machine
without them runs the other checks on a checkpoint the port wrote
(``utils/checkpoint.save_hf_checkpoint``) with a processor passed in.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPT = "describe the chart"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _ckpt_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)
               if n.endswith(".safetensors")) / 1e6


class SkipCheck(Exception):
    pass


class TokensDiffer(AssertionError):
    """A token check's failure, with the two streams and where they part."""

    def __init__(self, msg: str, base, got):
        super().__init__(msg)
        div = next((i for i, (a, b) in enumerate(zip(base, got)) if a != b), min(len(base), len(got)))
        self.detail = {"base_tokens": list(base), "tokens": list(got), "first_difference": div}


def harness_inputs(processor, cfg, device, dtype):
    """The prompt and seeded image every check runs: (input_ids, pixel_values)
    on ``device``, the pixels in ``dtype``."""
    import numpy as np
    import torch
    from PIL import Image

    size = cfg.vision_config.image_size
    img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (size, size, 3), np.uint8))
    inputs = processor(text=[PROMPT], images=[img])
    return (torch.from_numpy(inputs["input_ids"]).to(device),
            torch.from_numpy(inputs["pixel_values"]).to(device, dtype))


def _agreement(base, got) -> float:
    n = min(len(base), len(got))
    return sum(a == b for a, b in zip(base[:n], got[:n])) / max(n, 1)


def run_checks(model_path: str, tokens: int = 16, hf_mode: str = "auto", streaming_mode: str = "auto",
               max_hf_mb: float = 2000.0, device: str = "cuda", processor=None) -> dict:
    """Every check on the checkpoint at ``model_path``; returns the report.
    ``device``: "cuda" (bf16) or "cpu" (fp32). ``processor``: a built
    processor to hold to the config instead of loading ``AutoTokenizer``."""
    import numpy as np
    import torch

    report = {"model_path": os.path.abspath(model_path), "checks": {}}

    def record(name, status, **detail):
        report["checks"][name] = {"status": status, **detail}
        log(f"[{status:>7}] {name}: {detail}")

    def guard(name):
        def deco(fn):
            t0 = time.time()
            try:
                detail = fn() or {}
                if on_card:
                    torch.cuda.synchronize()
                detail["seconds"] = round(time.time() - t0, 2)
                record(name, "pass", **detail)
            except SkipCheck as e:
                record(name, "skipped", reason=str(e))
            except Exception as e:
                record(name, "fail", error=repr(e), trace=traceback.format_exc()[-1500:],
                       **getattr(e, "detail", {}))
            finally:
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
        return deco

    on_card = torch.device(device).type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    ckpt_mb = _ckpt_mb(model_path)
    report["checkpoint_mb"] = round(ckpt_mb, 1)
    report["platform"] = torch.device(device).type
    if on_card:
        report["device_name"] = torch.cuda.get_device_name(0)
    state = {}

    @guard("config")
    def _config():
        from paligemma_tpu_torch.config import PaliGemmaConfig

        cfg = PaliGemmaConfig.from_json(os.path.join(model_path, "config.json"))
        state["cfg"] = cfg
        return {"text_layers": cfg.text_config.num_hidden_layers,
                "vision_layers": cfg.vision_config.num_hidden_layers,
                "vocab": cfg.text_config.vocab_size,
                "image_tokens": cfg.vision_config.num_image_tokens}

    @guard("tokenizer")
    def _tokenizer():
        if "cfg" not in state:
            raise SkipCheck("config failed")
        from paligemma_tpu_torch.processing import PaliGemmaProcessor, assert_aligned

        cfg = state["cfg"]
        if processor is not None:
            proc, source = processor, "given"
        else:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(model_path, padding_side="right")
            proc = PaliGemmaProcessor(tok, num_image_tokens=cfg.vision_config.num_image_tokens,
                                      image_size=cfg.vision_config.image_size)
            source = "AutoTokenizer"
        assert_aligned(proc, cfg)
        tok = proc.tokenizer
        # The reference's token registration: the whole loc/seg vocabulary.
        for marker in ("<loc0000>", "<loc1023>", "<seg000>", "<seg127>"):
            tid = tok.convert_tokens_to_ids(marker)
            if tid is None or tid < 0:
                raise AssertionError(f"{marker} not registered")
        state["proc"] = proc
        size = len(tok) if hasattr(tok, "__len__") else tok.vocab_size
        return {"image_token_id": proc.image_token_id, "tokenizer_len": size, "source": source}

    @guard("load")
    def _load():
        if "cfg" not in state:
            raise SkipCheck("config failed")
        from paligemma_tpu_torch.utils.checkpoint import load_model

        streaming = streaming_mode == "on" or (streaming_mode == "auto" and ckpt_mb > 2000)
        rss0 = _rss_mb()
        model, cfg = load_model(model_path, dtype=dtype, streaming=streaming, device=device)
        state["model"], state["cfg"] = model, cfg
        return {"streaming": streaming, "n_params": sum(p.numel() for p in model.parameters()),
                "host_rss_delta_mb": round(_rss_mb() - rss0, 1)}

    def ready():
        if "model" not in state or "proc" not in state:
            raise SkipCheck("load or tokenizer failed")
        return state["model"], state["cfg"], state["proc"]

    def generate(model):
        from paligemma_tpu_torch import generation

        ids, pix = harness_inputs(state["proc"], state["cfg"], device, dtype)
        eos = state["proc"].tokenizer.eos_token_id
        return generation.generate_chunked(model, ids, pix, tokens, -1 if eos is None else eos,
                                           cache_dtype=dtype, chunk=min(16, tokens))

    @guard("logit_parity")
    def _parity():
        _, cfg, proc = ready()
        if hf_mode == "off":
            raise SkipCheck("--hf off")
        if hf_mode == "auto" and ckpt_mb > max_hf_mb:
            raise SkipCheck(f"checkpoint {ckpt_mb:.0f} MB > --max_hf_mb {max_hf_mb:.0f} (the fp32 CPU oracle "
                            "would not fit); pass --hf on to force")
        try:
            from transformers import PaliGemmaForConditionalGeneration
        except ImportError as e:
            raise SkipCheck(f"transformers is not installed ({e})")
        from paligemma_tpu_torch import generation
        from paligemma_tpu_torch.models import paligemma
        from paligemma_tpu_torch.utils.checkpoint import load_model

        hf = PaliGemmaForConditionalGeneration.from_pretrained(model_path, torch_dtype=torch.float32,
                                                               attn_implementation="eager").eval()
        ids, pix = harness_inputs(proc, cfg, "cpu", torch.float32)
        hf_in = {"input_ids": ids.long(), "pixel_values": pix, "attention_mask": torch.ones_like(ids.long())}
        with torch.no_grad():
            hf_logits = hf(**hf_in).logits.numpy()
        # The fp32 arm on the CPU (bf16 would fail 1e-3 trivially).
        model32, _ = load_model(model_path, dtype=torch.float32, device="cpu")
        cache = generation.make_cache(model32, 1, ids.shape[1], 4, torch.float32)
        with torch.no_grad():
            ours, _ = paligemma.prefill(model32, ids, pix, cache)
        diff = float(np.max(np.abs(ours.numpy() - hf_logits)))
        if diff > 1e-3 + 1e-3 * float(np.max(np.abs(hf_logits))):
            raise AssertionError(f"prefill logits diverge: max abs diff {diff}")
        with torch.no_grad():
            hf_tokens = hf.generate(**hf_in, max_new_tokens=8, do_sample=False)[0, ids.shape[1]:].tolist()
        eos = proc.tokenizer.eos_token_id
        ours_tokens = generation.generate_chunked(model32, ids, pix, 8, -1 if eos is None else eos,
                                                  cache_dtype=torch.float32, chunk=4)
        if ours_tokens != hf_tokens[:len(ours_tokens)]:
            raise TokensDiffer(f"greedy tokens diverge: ours {ours_tokens} hf {hf_tokens}", hf_tokens, ours_tokens)
        return {"max_abs_logit_diff": diff, "greedy_tokens": ours_tokens}

    @guard("int8_identity")
    def _int8():
        from paligemma_tpu_torch.quantization import quantize_params

        model = ready()[0]
        base = generate(model)
        q = generate(quantize_params(model, llm_only=True))
        if base != q:
            raise TokensDiffer(f"int8 tokens diverge from {'bf16' if on_card else 'fp32'}: {q[:8]} vs {base[:8]}",
                               base, q)
        return {"tokens_compared": len(base)}

    @guard("w4a8_agreement")
    def _w4a8():
        from paligemma_tpu_torch.quantization import quantize_params

        model = ready()[0]
        base = generate(model)
        q = generate(quantize_params(model, llm_only=True, mode="w4a8"))
        agree = _agreement(base, q)
        # Identity is not required of w4a8 (per-row activation quantization):
        # the bar is high agreement, with identity recorded.
        if agree < 0.9:
            raise TokensDiffer(f"w4a8 agreement {agree:.2f} < 0.9: {q[:8]} vs {base[:8]}", base, q)
        state["w4a8_base"] = base
        return {"tokens_compared": min(len(base), len(q)), "agreement": round(agree, 4),
                "token_identical": base == q}

    @guard("lm_head_w4_agreement")
    def _lmw4():
        # The 4-bit tied lm_head on the w4a8 model: the final logits carry
        # int4 weight and int8 activation error.
        if "w4a8_base" not in state:
            raise SkipCheck("w4a8 check did not run")
        from paligemma_tpu_torch.quantization import quantize_params

        base = state["w4a8_base"]
        q = generate(quantize_params(ready()[0], llm_only=True, mode="w4a8", lm_head_w4=True))
        agree = _agreement(base, q)
        if agree < 0.9:
            raise TokensDiffer(f"lm_head_w4 agreement {agree:.2f} < 0.9: {q[:8]} vs {base[:8]}", base, q)
        return {"tokens_compared": min(len(base), len(q)), "agreement": round(agree, 4),
                "token_identical": base == q}

    @guard("a8_prefill_agreement")
    def _a8():
        from paligemma_tpu_torch.quantization import quantize_params

        model = ready()[0]
        base = generate(quantize_params(model, llm_only=True))
        a8 = generate(quantize_params(model, llm_only=True, prefill_a8=True))
        # The int8 x int8 prefill is the documented non-identical mode:
        # recorded, not gated.
        return {"tokens_compared": min(len(base), len(a8)), "agreement": round(_agreement(base, a8), 4),
                "token_identical": base == a8}

    @guard("lora_smoke")
    def _lora():
        from paligemma_tpu_torch import lora

        model, cfg, proc = ready()
        lcfg = lora.LoraConfig(r=4, alpha=8, dropout=0.0)
        adapter = lora.init_lora(cfg, lcfg, torch.Generator(device=device).manual_seed(0), device)
        before = [t.clone() for t in lora.adapter_leaves(adapter)]
        opt = lora.default_optimizer(lr=1e-3, accum_steps=1)
        step = lora.make_train_step(lcfg, opt)
        ids, pix = harness_inputs(proc, cfg, device, dtype)
        labels = torch.where(ids == cfg.image_token_index, -100, ids)
        loss, adapter, _ = step(model, adapter, opt.init(adapter),
                                {"input_ids": ids, "pixel_values": pix, "labels": labels},
                                torch.Generator(device=device).manual_seed(1))
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
        if not any(float((a - b).abs().max()) > 0 for a, b in zip(before, lora.adapter_leaves(adapter))):
            raise AssertionError("adapter did not move after one step")
        return {"loss": round(loss, 4)}

    state.clear()
    statuses = [c["status"] for c in report["checks"].values()]
    report["ok"] = "fail" not in statuses
    report["summary"] = {s: statuses.count(s) for s in ("pass", "fail", "skipped")}
    return report


# The JAX script's geometries (shared with tests/test_golden_parity.py): the
# flagship's extreme ratios at 2 layers, and a tiny one.
SELFTEST_GEOMETRIES = {
    "tiny": dict(
        vision=dict(hidden_size=24, intermediate_size=48, num_attention_heads=4, num_hidden_layers=2,
                    patch_size=8, image_size=32),
        text=dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=8, num_hidden_layers=2),
        projection_dim=32,
    ),
    "flagship-ratios": dict(
        vision=dict(hidden_size=1152, intermediate_size=2304, num_attention_heads=16, num_hidden_layers=2,
                    patch_size=14, image_size=140),
        text=dict(hidden_size=2048, intermediate_size=4096, num_attention_heads=8, num_key_value_heads=1,
                  head_dim=256, num_hidden_layers=2),
        projection_dim=2048,
    ),
}


def synthesize_checkpoint(path: str, geometry: str) -> str:
    """Write an HF-format checkpoint and a real fast tokenizer (WordLevel,
    bos/eos/pad/unk, then the processor's <image>, loc and seg tokens) at
    ``geometry``, as the JAX script does. flagship-ratios has the real
    257,152-row vocab, far more rows than the tokenizer has ids."""
    import torch
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PaliGemmaConfig as HFPaliGemmaConfig
    from transformers import PaliGemmaForConditionalGeneration, PreTrainedTokenizerFast

    from paligemma_tpu_torch.processing import PaliGemmaProcessor

    geo = SELFTEST_GEOMETRIES[geometry]
    words = ["describe", "the", "chart", "image", "revenue", "trend", "rising", "falling", "axis", "legend",
             "bar", "line", "price", "volume", "profit", "loss", "growth", "table", "report"]
    vocab = {"<pad>": 0, "<unk>": 1, "<bos>": 2, "<eos>": 3}
    for w in words:
        vocab[w] = len(vocab)
    core = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = Whitespace()
    tok = PreTrainedTokenizerFast(tokenizer_object=core, bos_token="<bos>", eos_token="<eos>", pad_token="<pad>",
                                  unk_token="<unk>")
    n_img = (geo["vision"]["image_size"] // geo["vision"]["patch_size"]) ** 2
    proc = PaliGemmaProcessor(tok, num_image_tokens=n_img, image_size=geo["vision"]["image_size"])
    tok.save_pretrained(path)
    hf_cfg = HFPaliGemmaConfig(
        vision_config=dict(projection_dim=geo["projection_dim"], **geo["vision"]),
        text_config=dict(vocab_size=257152 if geometry == "flagship-ratios" else len(tok),
                         max_position_embeddings=8192, **geo["text"]),
        image_token_index=proc.image_token_id, pad_token_id=0, projection_dim=geo["projection_dim"],
        hidden_size=geo["text"]["hidden_size"],
    )
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    log(f"synthesizing {geometry} checkpoint at {path} ...")
    PaliGemmaForConditionalGeneration(hf_cfg).eval().save_pretrained(path, safe_serialization=True)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("model_path", nargs="?", default=None)
    ap.add_argument("--out", default=None, help="JSON report path (default: stdout only)")
    ap.add_argument("--tokens", type=int, default=16, help="greedy tokens of each token check")
    ap.add_argument("--hf", choices=["auto", "on", "off"], default="auto", help="HF-transformers logit-parity oracle")
    ap.add_argument("--streaming", choices=["auto", "on", "off"], default="auto",
                    help="streaming (host-memory-bounded) load; auto = on for checkpoints > 2 GB")
    ap.add_argument("--max_hf_mb", type=float, default=2000.0)
    ap.add_argument("--only_cpu", action="store_true", help="run on the CPU in fp32 (default: the card in bf16)")
    ap.add_argument("--selftest", choices=sorted(SELFTEST_GEOMETRIES), default=None,
                    help="no checkpoint needed: synthesize one at this geometry and validate it (HF parity "
                         "forced on; needs transformers)")
    args = ap.parse_args(argv)

    import torch

    if not args.only_cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --only_cpu to run on the CPU", file=sys.stderr)
        return 1
    tmpdir = None
    if args.selftest:
        if args.model_path is None:
            import tempfile

            tmpdir = tempfile.TemporaryDirectory(prefix="pg_selftest_")
            args.model_path = tmpdir.name
        synthesize_checkpoint(args.model_path, args.selftest)
        args.hf = "on"  # the parity bar is the point of the selftest
    elif args.model_path is None:
        ap.error("model_path is required unless --selftest is given")

    try:
        report = run_checks(args.model_path, args.tokens, args.hf, args.streaming, args.max_hf_mb,
                            device="cpu" if args.only_cpu else "cuda")
    finally:
        if tmpdir is not None:
            tmpdir.cleanup()
    if args.selftest:
        report["selftest_geometry"] = args.selftest
    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

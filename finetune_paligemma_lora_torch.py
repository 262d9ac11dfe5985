"""LoRA finetuning CLI of the PyTorch port (``paligemma_tpu_torch``), the
counterpart of ``finetune_paligemma_lora.py``, with its flags and defaults.

    python3 finetune_paligemma_lora_torch.py --model_path DIR --parquet_file F --images_folder D
    python3 finetune_paligemma_lora_torch.py --demo --only_cpu=True --parquet_file F --images_folder D
    python3 ... --eval_only [--adapter_dir DIR]

Flow: validate the dataset, load the model (``utils/checkpoint.load_model``
with ``--model_path``; ``--demo``: the tiny random model and the byte
tokenizer), the parquet dataset, then ``lora.train`` (AdamW over the
adapters, accumulation, clipping, periodic robust checkpoints). With
``--eval_only``: the exact token-weighted mean loss and the perplexity over
the whole dataset, through ``--adapter_dir``'s adapter when given (the tail
batch padded with repeated samples whose labels are all ignored). On the
card the train step and the eval loss replay CUDA graphs
(``lora.make_train_step``, ``lora.make_eval_loss``); on the CPU they run
eagerly.

Runs on the CUDA card; ``--only_cpu=True`` is the only way onto the CPU.
``--max_memory_gb`` is accepted and not used.
"""
from __future__ import annotations

import argparse
import sys


def str2bool(v) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--parquet_file", type=str, required=True)
    p.add_argument("--images_folder", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="paligemma_lora")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_length", type=int, default=256)
    p.add_argument("--only_cpu", type=str2bool, default=False)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--device", type=str, default=None, help="a CUDA device (default: cuda)")
    p.add_argument("--accum_steps", type=int, default=16)
    p.add_argument("--save_every_n_steps", type=int, default=50)
    p.add_argument("--max_memory_gb", type=float, default=4.5)
    p.add_argument("--max_samples", type=int, default=150)
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--lora_dropout", type=float, default=0.1)
    p.add_argument("--demo", action="store_true", help="tiny random model + byte tokenizer (no checkpoint)")
    p.add_argument("--eval_only", action="store_true",
                   help="no training: mean CE loss + perplexity over the dataset (with --adapter_dir, "
                        "through the saved adapter)")
    p.add_argument("--adapter_dir", type=str, default=None, help="eval: saved adapter directory to apply (unmerged)")
    return p


def evaluate(model, dataset, batch_size: int, adapter=None, scale: float = 1.0):
    """(mean loss over every valid label token, tokens, batches): each
    batch's loss (``lora.make_eval_loss``: a CUDA graph on the card, one for
    every batch since all have one shape) weighted by its valid shifted
    labels (``loss_fn``'s denominator); the tail batch is padded with copies
    of its first sample whose labels are all ``ignore_index``."""
    import numpy as np

    from paligemma_tpu_torch.lora import batch_to, make_eval_loss

    ignore = model.cfg.ignore_index
    dev = model.llm.final_norm.weight.device
    loss_of = make_eval_loss(scale)
    n = len(dataset)
    total_nll, total_tok, n_batches = 0.0, 0, 0
    for start in range(0, n, batch_size):
        take = list(range(start, min(start + batch_size, n)))
        samples = [dataset[i] for i in take]
        samples += [samples[0]] * (batch_size - len(take))  # pad rows
        batch = {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}
        if len(take) < batch_size:
            batch["labels"] = batch["labels"].copy()
            batch["labels"][len(take):] = ignore
        ntok = int((batch["labels"][:, 1:] != ignore).sum())
        if ntok == 0:
            continue
        total_nll += float(loss_of(model, adapter, batch_to(batch, dev))) * ntok
        total_tok += ntok
        n_batches += 1
    return (total_nll / total_tok if total_tok else None), total_tok, n_batches


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    import math

    import torch

    if not args.only_cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --only_cpu=True to run on the CPU", file=sys.stderr)
        return 1
    device = "cpu" if args.only_cpu else (args.device or "cuda")
    print("Device in use: ", device if device == "cpu" else torch.cuda.get_device_name(torch.device(device)))

    from inference_torch import load_for_cli
    from paligemma_tpu_torch import lora as lora_lib
    from paligemma_tpu_torch.data import FinancialImageDataset, validate_dataset

    print("Validating dataset")
    validate_dataset(args.parquet_file, args.images_folder, max_check=100)

    print("Loading model")
    demo = args.demo or not args.model_path
    model, processor = load_for_cli(args.model_path, demo, device=device)
    cfg = model.cfg
    image_size = cfg.vision_config.image_size if demo else args.image_size
    dataset = FinancialImageDataset(
        args.parquet_file, args.images_folder, processor.tokenizer,
        num_image_tokens=cfg.vision_config.num_image_tokens, image_size=image_size,
        max_length=args.max_length, max_samples=args.max_samples, ignore_index=cfg.ignore_index,
    )
    print(f"Dataset: {len(dataset)} samples")
    lcfg = lora_lib.LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)

    if args.eval_only:
        adapter = None
        if args.adapter_dir:
            adapter = lora_lib.load_adapter(args.adapter_dir, device=device)
            rank = int(adapter["layers"]["q"]["a"].shape[-1])
            r, alpha = lora_lib.saved_rank_alpha(args.adapter_dir, rank, args.lora_alpha)
            lcfg = lora_lib.LoraConfig(r=r, alpha=alpha, dropout=0.0)
        if len(dataset) == 0:
            print("error: dataset is empty", file=sys.stderr)
            return 2
        mean, ntok, n_batches = evaluate(model, dataset, args.batch_size, adapter, lcfg.scale)
        if mean is None:
            print("error: no valid label tokens in the dataset", file=sys.stderr)
            return 2
        print(f"Eval: {len(dataset)} samples / {n_batches} batches | mean loss {mean:.4f} over {ntok} tokens | "
              f"perplexity {math.exp(min(mean, 20.0)):.2f}"
              + (f" | adapter {args.adapter_dir}" if args.adapter_dir else ""))
        return 0

    _, losses = lora_lib.train(
        model,
        lambda epoch: dataset.batches(args.batch_size, shuffle=True, seed=epoch, epochs=1),
        lcfg=lcfg, lr=args.lr, accum_steps=args.accum_steps, epochs=args.epochs,
        save_every_n_steps=args.save_every_n_steps, output_dir=args.output_dir,
    )
    if losses:
        print(f"Final loss: {losses[-1]:.4f} over {len(losses)} steps")
    print(f"Adapter saved to {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

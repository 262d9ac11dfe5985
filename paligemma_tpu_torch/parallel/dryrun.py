"""The multi-process dry run on the CPU (the counterpart of the JAX
package's ``dryrun_multichip``):

    python -m paligemma_tpu_torch.parallel.dryrun 4

spawns n ranks over gloo on the CPU and, on ``tiny_config`` in fp32:

- one DP x TP LoRA train step with dropout on a (data, model) mesh (both
  axes > 1 where n allows): the loss is finite;
- the sharded prefill and decode: the decode logits are the whole vocab
  and the same on every rank of a model group, the cache holds this data
  rank's rows, the LoRA q B this model rank's columns;
- a 2-stage pipeline's loss within 1e-4 of the unsharded loss, and a finite
  gradient through its backward;
- the continuous engine over a TP mesh of all n ranks, token-identical to
  the unsharded engine: plain, speculative (k = 3), int8 KV cache with the
  cache window, int8 weights, w4a8 (speculative), and w4a8 with the 4-bit
  lm_head (each quantized arm against the unsharded engine of its weights).

Rank 0 prints one summary line.
"""
from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch


def _factor(n: int):
    """(data, model) with both > 1 where n allows, model the larger."""
    for cand in range(int(math.isqrt(n)), 0, -1):
        if n % cand == 0:
            return cand, n // cand
    return 1, n


def _rank_run(n: int) -> dict:
    import torch.distributed as dist
    from PIL import Image

    from paligemma_tpu_torch import tiny_config
    from paligemma_tpu_torch.continuous import ContinuousBatcher
    from paligemma_tpu_torch.lora import LoraConfig, default_optimizer, init_lora
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.parallel import comm, pipeline, sharding, steps
    from paligemma_tpu_torch.parallel.mesh import make_mesh
    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor, align_config
    from paligemma_tpu_torch.quantization import quantize_params

    data, model = _factor(n)
    mesh = make_mesh(data, model, device="cpu")
    cfg = tiny_config()
    params = paligemma.init_params(cfg, 0, device="cpu")
    sparams = sharding.shard_params(params, cfg, mesh)
    b = max(data, 2)
    n_img = cfg.vision_config.num_image_tokens
    ids = torch.cat([torch.full((b, n_img), cfg.image_token_index), torch.full((b, 4), 7)], 1).int()
    size = cfg.vision_config.image_size
    pix = torch.zeros((b, 3, size, size))
    rows = lambda x: sharding.shard_batch(x, mesh)  # noqa: E731

    # DP x TP train step (dropout on: the model group's generators alike).
    lcfg = LoraConfig(r=2, alpha=4, dropout=0.1)
    adapter = sharding.shard_lora(init_lora(cfg, lcfg, torch.Generator().manual_seed(1), device="cpu"),
                                  cfg, mesh)
    train = steps.make_sharded_train_step(cfg, lcfg, default_optimizer(lr=1e-3, accum_steps=1), mesh)
    opt_state = train.optimizer.init(adapter)
    batch = {"input_ids": rows(ids), "pixel_values": rows(pix), "labels": rows(ids)}
    gen = torch.Generator().manual_seed(2 + mesh.data_rank)
    loss, adapter, opt_state = train(sparams, adapter, opt_state, batch, gen)
    loss = float(loss)
    assert np.isfinite(loss), loss

    # Sharded prefill + decode.
    cache = gemma.init_cache(sparams.cfg.text_config, b // data, ids.shape[1] + 4, torch.float32, "cpu")
    logits, cache = steps.make_sharded_prefill(cfg, mesh)(sparams, rows(ids), rows(pix), cache)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    logits2, cache = steps.make_sharded_decode(cfg, mesh)(sparams, tok, cache)
    vocab = cfg.text_config.vocab_size
    assert logits2.shape == (b // data, 1, vocab), f"decode logits not whole: {tuple(logits2.shape)}"
    everyone = comm.all_gather(logits2[None], mesh.model_group, 0)
    assert all(torch.equal(x, logits2) for x in everyone), "decode logits not replicated over the model group"
    assert cache.k.shape[1] == b // data, f"cache not split by data rank: {tuple(cache.k.shape)}"
    q_out = cfg.text_config.num_attention_heads * cfg.text_config.head_dim
    if model > 1 and q_out % model == 0:
        assert adapter["layers"]["q"]["b"].shape[-1] == q_out // model, "lora q B not split by model rank"

    # Pipeline: 2 stages (each pair of ranks runs one).
    n_pipe = 2 if n >= 2 else 1
    layers = max(n_pipe, cfg.text_config.num_hidden_layers // n_pipe * n_pipe)
    pcfg = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=layers))
    pparams = paligemma.init_params(pcfg, 3, device="cpu")
    pmesh = pipeline.make_pipe_mesh(n_pipe, device="cpu")
    ref_loss = float(paligemma.loss_fn(pparams, ids, pix, ids))
    for layer in pipeline.stage_params(pparams.llm, n_pipe)[pmesh.stage]:
        layer.qkv.weight.requires_grad_(True)
    pp = pipeline.pipelined_loss_fn(pparams, pcfg, ids, pix, ids, pmesh, n_microbatches=2)
    pp.backward()
    pp_loss = pp.item()
    assert abs(pp_loss - ref_loss) < 1e-4, (pp_loss, ref_loss)
    grads = [layer.qkv.weight.grad for layer in pipeline.stage_params(pparams.llm, n_pipe)[pmesh.stage]]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads), "pp grad not finite"

    # The continuous engine over a TP mesh of every rank.
    proc = PaliGemmaProcessor(ByteTokenizer(), num_image_tokens=n_img, image_size=size)
    scfg = align_config(tiny_config(), proc)
    sv = paligemma.init_params(scfg, 7, device="cpu")
    rng = np.random.RandomState(0)
    prompts = ["describe the chart", "total revenue", "trend"]
    images = [Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)) for _ in prompts]
    tp_mesh = make_mesh(1, n, device="cpu")

    def serve(m, **kw):
        eng = ContinuousBatcher(m, proc, n_slots=2, max_new_tokens=6, chunk=2, cache_dtype=torch.float32, **kw)
        try:
            reqs = [eng.submit(p, im) for p, im in zip(prompts, images)]
            eng.run()
        finally:
            eng.close()
        assert all(r.error is None for r in reqs), [r.error for r in reqs]
        return [r.tokens for r in reqs]

    def tp(m):
        return sharding.shard_params(m, scfg, tp_mesh)

    base = serve(sv)
    ssv = tp(sv)
    assert ssv.llm.layers[0].attn_tp is not None, "serving model not TP-sharded"
    same = {"serving": serve(ssv) == base, "spec_serving": serve(ssv, spec_k=3) == base,
            "kvquant_serving": serve(ssv, kv_quant=True, kv_window=True) == base}
    q8 = quantize_params(sv, llm_only=True)
    same["int8_serving"] = serve(tp(q8)) == serve(q8)
    w4 = quantize_params(sv, llm_only=True, mode="w4a8")
    same["w4a8_serving"] = serve(tp(w4), spec_k=3) == serve(w4)
    l4 = quantize_params(sv, llm_only=True, mode="w4a8", lm_head_w4=True)
    same["lmw4_serving"] = serve(tp(l4)) == serve(l4)
    assert all(same.values()), f"TP serving diverged from the unsharded engine: {same}"

    line = (f"dryrun_multichip ok: mesh=({data}x{model}) loss={loss:.4f} "
            f"decode_logits={tuple(logits2.shape)} pp(stages={n_pipe})_loss={pp_loss:.4f} "
            + " ".join(f"{k}(tp={n})_tokens_identical={v}" for k, v in same.items())
            + f" backend={mesh.backend}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return {"line": line, "loss": loss, "pp_loss": pp_loss, "ref_loss": ref_loss, "same": same}


def dryrun_multichip(n: int) -> str:
    """Run the dry run on ``n`` CPU ranks; returns rank 0's summary line."""
    from paligemma_tpu_torch.parallel.mesh import spawn

    return spawn(_rank_run, n, "gloo", "cpu", n)[0]["line"]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)

"""Rank functions of the port's multi-process tests (``test_torch_parallel.py``,
``test_torch_pipeline.py``).

Spawned ranks import the module that holds their function, so these live
apart from the test files (which import JAX): this module imports only the
port. Each function builds the port's model from a JAX parameter tree of
numpy arrays (``utils/convert.from_jax_params``), runs its part on its rank
of a gloo group on the CPU and returns numpy arrays (and the rank's place)
for the test process to hold against JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paligemma_tpu_torch import quantization, tiny_config
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.parallel import pipeline, sharding, steps
from paligemma_tpu_torch.parallel.mesh import make_mesh
from paligemma_tpu_torch.utils.convert import from_jax_params, lora_from_jax, lora_to_jax


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy (the cache changes in place after it is read)."""
    return t.detach().to(torch.float32).numpy().copy()


def _prefill(model, cfg, mesh, ids, pix, extra: int = 4, sequence_parallel: bool = False):
    """The sharded prefill of this rank's rows: (logits, cache)."""
    b = ids.shape[0] // mesh.data
    cache = gemma.init_cache(model.cfg.text_config, b, ids.shape[1] + extra, torch.float32, "cpu")
    run = steps.make_sharded_prefill(cfg, mesh, sequence_parallel=sequence_parallel)
    return run(model, sharding.shard_batch(torch.from_numpy(ids), mesh),
               sharding.shard_batch(torch.from_numpy(pix), mesh), cache)


def mesh_worker(tree, ids, pix, data, model_size, checks):
    """The sharded prefill on a (data, model) mesh, and the ``checks`` asked
    for: "decode" (one step after it), "sp" (sequence parallel), "int8" and
    "a8" (quantized prefills), "bytes" (the rank's bytes and its gate/up
    rows), "train" / "train_unequal" (one DP x TP LoRA step; see
    ``_train``)."""
    cfg = tiny_config()
    mesh = make_mesh(data, model_size, device="cpu")
    full = from_jax_params(tree, cfg, device="cpu")
    model = sharding.shard_params(full, cfg, mesh)
    first, count = sharding.cache_heads(cfg, mesh)
    out = {"rank": (mesh.data_rank, mesh.model_rank), "kv": (first, count)}
    logits, cache = _prefill(model, cfg, mesh, ids, pix)
    out["logits"], out["k"] = _np(logits), _np(cache.k)
    if "decode" in checks:
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["decode_tok"] = tok.numpy()
        out["decode"] = _np(steps.make_sharded_decode(cfg, mesh)(model, tok, cache)[0])
    if "sp" in checks:
        out["sp"] = _np(_prefill(model, cfg, mesh, ids, pix, sequence_parallel=True)[0])
    for arm in ("int8", "a8"):
        if arm in checks:  # the rank's and the unsharded quantized model's logits
            if arm == "a8":
                quantization.A8_MIN_SEQ = 8  # the tiny prompt is 22 tokens (JAX's a8_min_seq = 8)
            qf = quantization.quantize_params(full, llm_only=True, prefill_a8=arm == "a8")
            out[arm] = _np(_prefill(sharding.shard_params(qf, cfg, mesh), cfg, mesh, ids, pix)[0])
            cache = gemma.init_cache(cfg.text_config, ids.shape[0], ids.shape[1] + 4, torch.float32, "cpu")
            whole = paligemma.prefill(qf, torch.from_numpy(ids), torch.from_numpy(pix), cache)[0]
            out[arm + "_whole"] = _np(sharding.shard_batch(whole, mesh))
    if "bytes" in checks:
        out["bytes"] = quantization.params_bytes(model)
        out["want_bytes"] = sharding.rank_bytes(full, cfg, mesh.model)
        out["full_bytes"] = quantization.params_bytes(full)
        for name in ("int8", "w4a8"):
            qf = quantization.quantize_params(full, llm_only=True, mode=name)
            out[f"bytes_{name}"] = quantization.params_bytes(sharding.shard_params(qf, cfg, mesh))
            out[f"want_bytes_{name}"] = sharding.rank_bytes(qf, cfg, mesh.model)
        # The rank's gate/up rows: its gate slice and the matching up slice.
        out["gate_up"] = _np(model.llm.layers[0].gate_up.weight)
        out["gate_up_full"] = _np(full.llm.layers[0].gate_up.weight)
    for name in ("train", "train_unequal"):
        if name in checks:
            out[name] = _train(full, cfg, mesh, **checks[name])
    return out


def _train(full, cfg, mesh, batch, adapter, lr):
    """One DP x TP micro-step from ``adapter`` (a JAX adapter tree) on the
    whole ``batch`` (numpy): the loss, the rank's new adapter, and the
    port's unsharded ``lora.train_step`` from the same start."""
    from paligemma_tpu_torch import lora

    lcfg = lora.LoraConfig(r=2, alpha=4, dropout=0.0)
    model = sharding.shard_params(full, cfg, mesh)
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    rows = {k: sharding.shard_batch(v, mesh) for k, v in whole.items()}
    ad = sharding.shard_lora(lora_from_jax(adapter, device="cpu"), cfg, mesh)
    step = steps.make_sharded_train_step(cfg, lcfg, lora.default_optimizer(lr=lr, accum_steps=1), mesh)
    state = step.optimizer.init(ad)
    loss, ad, _ = step(model, ad, state, rows)
    ref_ad = lora_from_jax(adapter, device="cpu")
    opt = lora.default_optimizer(lr=lr, accum_steps=1)
    ref_loss, ref_ad, _ = lora.train_step(full, ref_ad, opt.init(ref_ad), whole, None, lcfg, opt)
    return {"loss": float(loss), "adapter": lora_to_jax(ad), "unsharded_loss": float(ref_loss),
            "unsharded_adapter": lora_to_jax(sharding.shard_lora(ref_ad, cfg, mesh))}


def engine_worker(tree, cfg_kw, subs, engine_kw, variants):
    """The continuous engine on a TP mesh of every rank over the requests
    ``subs`` ((prompt, image, max_new_tokens) each): each variant's tokens,
    sharded and unsharded."""
    from paligemma_tpu_torch.continuous import ContinuousBatcher
    from paligemma_tpu_torch.processing import ByteTokenizer, PaliGemmaProcessor

    c0 = tiny_config()
    proc = PaliGemmaProcessor(ByteTokenizer(), c0.vision_config.num_image_tokens, c0.vision_config.image_size)
    cfg = dataclasses.replace(c0, image_token_index=proc.image_token_id, **cfg_kw)
    full = from_jax_params(tree, cfg, device="cpu")
    mesh = make_mesh(1, None, device="cpu")
    model = sharding.shard_params(full, cfg, mesh)

    def run(served, kw):
        eng = ContinuousBatcher(served, proc, **engine_kw, **kw)
        try:
            reqs = [eng.submit(p, im, max_new_tokens=n) for p, im, n in subs]
            eng.run()
        finally:
            eng.close()
        assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
        return [r.tokens for r in reqs]

    return {"attn_tp": model.llm.layers[0].attn_tp is not None,
            **{name: {"tp": run(model, kw), "unsharded": run(full, kw)} for name, kw in variants.items()}}


def pipeline_worker(tree, layers, embeds, n_micro, loss_inputs):
    """The pipelined decoder forward over a pipe group of every rank, and
    with ``loss_inputs`` (ids, pix, labels) the pipelined loss and this
    stage's qkv gradients (``loss.backward()``)."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=layers))
    model = from_jax_params(tree, cfg, device="cpu")
    mesh = pipeline.make_pipe_mesh(torch.distributed.get_world_size(), device="cpu")
    out = {"stage": mesh.stage}
    x = torch.from_numpy(embeds)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32).expand(b, t)
    with torch.no_grad():
        out["hidden"] = _np(pipeline.pipelined_decoder_forward(model.llm, cfg.text_config, x, positions, mesh,
                                                               n_micro))
    if loss_inputs is not None:
        ids, pix, labels = (torch.from_numpy(a) for a in loss_inputs)
        mine = pipeline.stage_params(model.llm, mesh.stages)[mesh.stage]
        for layer in mine:
            layer.qkv.weight.requires_grad_(True)
        loss = pipeline.pipelined_loss_fn(model, cfg, ids, pix, labels, mesh, n_micro)
        loss.backward()
        out["loss"] = loss.item()
        out["unsharded_loss"] = float(paligemma.loss_fn(model, ids, pix, labels))
        per = layers // mesh.stages
        out["qkv_grads"] = {mesh.stage * per + i: _np(layer.qkv.weight.grad) for i, layer in enumerate(mine)}
    return out


def failing_worker():
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    rank = torch.distributed.get_rank()
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    torch.distributed.barrier()
    return rank

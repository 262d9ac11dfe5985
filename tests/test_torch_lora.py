"""LoRA in the PyTorch port (``paligemma_tpu_torch/lora.py``, the adapters
of ``models/gemma.py``, ``paligemma.loss_fn`` / ``forward``, the
``FlashAttentionFn`` backward) against the JAX package on the CPU.

Tiny config, fp32, the same weights in both packages (``from_jax_params``)
and the same adapters (``lora_from_jax``), B made non-zero so that every
gradient is.

- ``lora_delta`` shared and per row against ``_lora_delta``: within 1e-6
  (fp32) and two bf16 ulps (bf16); an all-zeros row exactly zero.
- Zero-init identity; ``forward_nocache`` with an adapter within 1e-5.
- ``loss_fn`` within 1e-5 relative and the adapter gradients within 1e-4
  relative of ``jax.value_and_grad`` of the train step's loss (dropout 0).
- The flash backward (``FlashAttentionPlainFn``, the backward the card's
  ``FlashAttentionFn`` runs) against ``jax.grad`` of JAX's attention under a
  ``LengthMask``: within 1e-5.
- 4 micro-steps with accumulation 2 and 3, the clip taken and not: the
  loss and the adapter after every call within 1e-5 / 1e-4 of JAX's jitted
  ``make_train_step`` + ``default_optimizer`` (unchanged mid-accumulation).
- A micro-step of each flavour reads nothing back to the host (a dispatch
  mode raises on any read): a CUDA graph can capture it.
- ``make_eval_loss`` against the reference CLI's ``eval_loss`` on a padded
  tail batch.
- ``merge_lora``'s weights within 1e-6 of JAX's, and its forward that of the
  adapter on the fly.
- Adapter files both ways, all three tiers, exactly; ``train`` smoke;
  resume equal to an uninterrupted run (after an update, and mid-way
  through an accumulation); dropout's kept share and scale;
  the reference-shaped ``forward`` router's routing, loss and errors.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import safetensors.numpy
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paligemma_tpu import lora as jlora
from paligemma_tpu.models import gemma as jgemma
from paligemma_tpu.models import paligemma as jpg
from paligemma_tpu.ops import attention as jattn
import paligemma_tpu_torch
from paligemma_tpu_torch import lora as tlora
from paligemma_tpu_torch.models import gemma
from paligemma_tpu_torch.models import paligemma as tpg
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.utils import checkpoint
from paligemma_tpu_torch.utils.convert import from_jax_params, lora_from_jax, lora_to_jax

LCFG = dict(r=4, alpha=8, dropout=0.0)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def setup(params, cfg):
    tcfg = dataclasses.replace(paligemma_tpu_torch.tiny_config(), image_token_index=cfg.image_token_index,
                               vocab_size=cfg.vocab_size)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    n_img = cfg.vision_config.num_image_tokens
    rng = np.random.RandomState(0)
    b, t_text = 2, 7
    ids = np.concatenate([np.full((b, n_img), cfg.image_token_index), rng.randint(2, 250, (b, t_text))], 1)
    ids = ids.astype(np.int32)
    size = cfg.vision_config.image_size
    pix = rng.randn(b, 3, size, size).astype(np.float32)
    labels = ids.copy()
    labels[:, :n_img] = cfg.ignore_index
    labels[1, -2:] = cfg.ignore_index  # row 1 right-padded
    valid = np.array([n_img + t_text, n_img + t_text - 2], np.int32)
    batch = {"input_ids": ids, "pixel_values": pix, "labels": labels, "valid_len": valid}
    return model, batch


def random_adapter(cfg, seed, r=4, scale_b=0.05):
    """A JAX adapter (numpy) with B drawn non-zero."""
    ad = jlora.init_lora(cfg, jlora.LoraConfig(**{**LCFG, "r": r}), jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 100)
    out = jax.tree_util.tree_map(np.asarray, ad)
    for mod in out["layers"].values():
        mod["b"] = (rng.randn(*mod["b"].shape) * scale_b).astype(np.float32)
    return out


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def leaves_by_name(jtree):
    flat = tlora._flatten(jtree)
    return [np.asarray(flat[k]) for k in sorted(flat)]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_matches_jax(per_row, dtype):
    rng = np.random.RandomState(1)
    b, t, d, r, out = 3, 5, 16, 4, 24
    x = rng.randn(b, t, d).astype(np.float32)
    a = rng.randn(*((b,) if per_row else ()), d, r).astype(np.float32) * 0.3
    bb = rng.randn(*((b,) if per_row else ()), r, out).astype(np.float32) * 0.3
    if per_row:
        a[1], bb[1] = 0.0, 0.0  # an all-zeros row: exactly no delta
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jgemma._lora_delta(jnp.asarray(x, jdt), {"a": jnp.asarray(a), "b": jnp.asarray(bb)}, 2.0, 0.0, None)
    got = gemma.lora_delta(torch.from_numpy(x).to(tdt), torch.from_numpy(a), torch.from_numpy(bb), 2.0)
    assert got.dtype == tdt
    ref, got = np.asarray(ref.astype(jnp.float32)), got.float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 * 2.0**-8
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max())
    if per_row:
        assert not got[1].any()


def test_lora_dropout_keeps_its_share_and_scales():
    """Dropout p = 0.25 under a seeded generator: about 3/4 of x's
    elements reach A (a binomial share within 4 sigma), each divided by
    0.75; the same seed draws the same mask."""
    n, d, p = 64, 256, 0.25
    x = torch.full((1, n, d), 3.0)
    eye = torch.eye(d)

    def kept(seed):
        g = torch.Generator().manual_seed(seed)
        return gemma.lora_delta(x, eye, eye, 1.0, p, g)  # A = B = I: the dropped x itself

    y = kept(5)
    vals = set(np.unique(y.numpy()).tolist())
    assert vals <= {0.0, 4.0}, vals  # 3 / 0.75
    share = float((y != 0).float().mean())
    sigma = (p * (1 - p) / (n * d)) ** 0.5
    assert abs(share - (1 - p)) < 4 * sigma, share
    assert torch.equal(y, kept(5)) and not torch.equal(y, kept(6))
    assert torch.equal(gemma.lora_delta(x, eye, eye, 1.0, p, None), x)  # no generator: no dropout


def test_zero_init_is_identity_and_adapter_forward_matches_jax(setup, params, cfg):
    model, batch = setup
    ids, pix, valid = (torch.from_numpy(batch[k]) for k in ("input_ids", "pixel_values", "valid_len"))
    lcfg = tlora.LoraConfig(**LCFG)
    zero = tlora.init_lora(model.cfg, lcfg, torch.Generator().manual_seed(3), device="cpu")
    assert not any(bool(t.any()) for name, t in tlora._flatten(zero).items() if name.endswith(".b"))
    base = tpg.forward_nocache(model, ids, pix, valid)
    assert torch.equal(base, tpg.forward_nocache(model, ids, pix, valid, lora=zero, lora_scale=lcfg.scale))

    ad = random_adapter(cfg, 7)
    ref = jpg.forward_nocache(params, cfg, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["pixel_values"]),
                              jnp.asarray(batch["valid_len"]), lora=ad, lora_scale=lcfg.scale)
    got = tpg.forward_nocache(model, ids, pix, valid, lora=lora_from_jax(ad, device="cpu"),
                              lora_scale=lcfg.scale)
    n = int(batch["valid_len"][1])
    assert rel_err(got[:, :n], np.asarray(ref)[:, :n]) < 1e-5
    assert rel_err(got, base) > 1e-3  # the adapter acts


def test_loss_and_adapter_gradients_match_jax(setup, params, cfg):
    """``loss_fn`` and ``make_train_step``'s gradient (dropout 0, B non-zero)
    against ``jax.value_and_grad`` of the reference step's loss."""
    model, batch = setup
    lcfg = jlora.LoraConfig(**LCFG)
    ad = random_adapter(cfg, 11)
    jb = jbatch(batch)

    def loss_of_lora(lora):
        return jpg.loss_fn(params, cfg, jb["input_ids"], jb["pixel_values"], jb["labels"],
                           valid_len=jb["valid_len"], lora=lora, lora_scale=lcfg.scale, lora_dropout=0.0)

    jl, jg = jax.value_and_grad(loss_of_lora)(jax.tree_util.tree_map(jnp.asarray, ad))
    tb = tbatch(batch)
    live = tlora._map(lambda t: t.requires_grad_(), lora_from_jax(ad, device="cpu"))
    tl = tpg.loss_fn(model, tb["input_ids"], tb["pixel_values"], tb["labels"], valid_len=tb["valid_len"],
                     lora=live, lora_scale=lcfg.scale)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = torch.autograd.grad(tl, tlora.adapter_leaves(live))
    for got, ref in zip(grads, leaves_by_name(jax.tree_util.tree_map(np.asarray, jg))):
        assert np.abs(ref).max() > 0
        assert rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("valid", [None, [29, 17]])
def test_flash_backward_matches_jax_grad(valid):
    """The flash Function's backward (its CPU twin: the plain forward and
    the same backward) against ``jax.grad`` of JAX's GQA attention under a
    ``LengthMask``, at GQA 4:2."""
    rng = np.random.RandomState(2)
    b, t, h, hkv, d = 2, 29, 4, 2, 16
    q, k, v = (rng.randn(b, t, n, d).astype(np.float32) for n in (h, hkv, hkv))
    w = rng.randn(b, t, h, d).astype(np.float32)
    vl = np.array([t, t] if valid is None else valid, np.int32)

    def jloss(q, k, v):
        mask = jattn.make_length_mask(jnp.asarray(vl)).materialize(t)
        return jnp.sum(jattn.gqa_attention(q, k, v, mask=mask) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ca.FlashAttentionPlainFn.apply(tq, tk, tv, None if valid is None else torch.from_numpy(vl))
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for got, r in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(r)).max())
    # The dispatching wrapper takes the Function under grad, the plain call without.
    assert ca.flash_attention(tq, tk, tv).grad_fn is not None
    with torch.no_grad():
        assert torch.equal(ca.flash_attention(tq, tk, tv), ca.flash_attention_plain(tq, tk, tv))


@pytest.mark.parametrize("accum", [2, 3])
@pytest.mark.parametrize("max_norm", [0.01, 1e3], ids=["clipped", "unclipped"])
def test_accumulated_steps_match_jax(setup, params, cfg, accum, max_norm):
    """4 micro-steps with accumulation 2 or 3 (crossing an update), the clip
    taken (max norm 0.01) or not (1e3): ``make_train_step``'s result (on
    the CPU, the eager step) against JAX's jitted step and optimizer, the
    loss and the adapter after each call."""
    model, batch = setup
    lcfg_j, lcfg_t = jlora.LoraConfig(**LCFG), tlora.LoraConfig(**LCFG)
    ad = random_adapter(cfg, 13)
    jopt = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(5e-3, weight_decay=0.0)),
                            every_k_schedule=accum)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, ad))
    jstep = jlora.make_train_step(cfg, lcfg_j, jopt, train=False)
    topt = tlora.AdapterOptimizer(lr=5e-3, accum_steps=accum, max_grad_norm=max_norm)
    tad = lora_from_jax(ad, device="cpu")
    tstate = topt.init(tad)
    tstep = tlora.make_train_step(lcfg_t, topt, train=False)
    jad = jax.tree_util.tree_map(jnp.asarray, ad)
    batches = [batch, {**batch, "labels": np.where(batch["labels"] >= 0, (batch["labels"] * 7) % 250, -100)
                       .astype(np.int32)}]
    prev = leaves_by_name(ad)
    for i in range(4):
        bt = batches[i % 2]
        jl, jad, jstate = jstep(params, jad, jstate, jbatch(bt), jax.random.PRNGKey(i))
        tl, tad, tstate = tstep(model, tad, tstate, tbatch(bt))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        ref = leaves_by_name(jax.tree_util.tree_map(np.asarray, jad))
        updated = (i + 1) % accum == 0
        if i == 0:  # the first gradient's norm is on the side of the bar the case says
            norm = float(torch.sqrt(sum((g * g).sum() for g in tstate["acc"])))
            assert (norm > max_norm) == (max_norm < 1.0), norm
        for got, r, p in zip(tlora.adapter_leaves(tad), ref, prev):
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
            if not updated:
                assert np.array_equal(got.numpy(), p)  # mid-accumulation: unchanged
        if updated:
            assert any(not np.array_equal(r, p) for r, p in zip(ref, prev))
        prev = [t.numpy().copy() for t in tlora.adapter_leaves(tad)]


class _NoHostRead(TorchDispatchMode):
    """Raises on an operation that reads a tensor back to the host (a
    scalar read, ``nonzero``, a copy from another device to the CPU), except
    a scalar read of a tensor made from a Python number in the same call
    (``torch.tensor(x)``, a host constant)."""

    READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
             torch.ops.aten.equal.default, torch.ops.aten.is_nonzero.default}

    def __init__(self):
        super().__init__()
        self.fresh, self.ops = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if func in self.READS and not (func is torch.ops.aten._local_scalar_dense.default
                                       and any(args[0] is t for t in self.fresh)):
            raise AssertionError(f"host read in the step: {func}")
        if func in (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default):
            src = args[1] if func is torch.ops.aten.copy_.default else args[0]
            dst = args[0].device if func is torch.ops.aten.copy_.default else kwargs.get("device")
            if dst is not None and torch.device(dst).type == "cpu" and src.device.type != "cpu":
                raise AssertionError(f"device-to-host copy in the step: {func}")
        out = func(*args, **kwargs)
        if func is torch.ops.aten.lift_fresh.default:
            self.fresh.append(out)
        return out


def test_a_micro_step_reads_nothing_back_from_the_device(setup):
    """A whole micro-step of each flavour (forward, ``autograd.grad``, the
    optimizer's ``apply``, dropout on) under a dispatch mode that raises on
    any read back to the host: what a CUDA graph can capture."""
    model, batch = setup
    lcfg = tlora.LoraConfig(r=2, alpha=4, dropout=0.1)
    opt = tlora.AdapterOptimizer(lr=1e-2, accum_steps=2, max_grad_norm=0.01)
    ad = tlora.init_lora(model.cfg, lcfg, torch.Generator().manual_seed(0), device="cpu")
    state = opt.init(ad)
    gen = torch.Generator().manual_seed(1)
    for applies in (False, True):
        assert opt.applies(state) == applies
        b0 = ad["layers"]["q"]["b"].clone()
        opt.set_scalars(state, "cpu")  # the host's part, filled before a replay
        with _NoHostRead() as mode:
            loss = tlora._step_on_device(model, ad, state, tbatch(batch), gen, lcfg, opt, train=True)
        assert mode.ops > 100 and torch.isfinite(loss)
        assert torch.equal(b0, ad["layers"]["q"]["b"]) != applies  # the apply flavour moved B
        state = opt.advance(state)


def test_eval_loss_matches_the_reference_cli_on_a_padded_tail_batch(setup, params, cfg):
    """``make_eval_loss`` (on the CPU, the eager loss) against the reference
    CLI's ``eval_loss`` arithmetic (JAX ``loss_fn`` through the adapter, no
    dropout) on a batch padded with a copy of row 0 whose labels are all
    ignored: the same loss, within 1e-5, and the same token weight."""
    model, batch = setup
    ad = random_adapter(cfg, 23)
    lcfg = jlora.LoraConfig(**LCFG)
    padded = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}
    padded["labels"][2:] = cfg.ignore_index
    jb = jbatch(padded)
    ref = jpg.loss_fn(params, cfg, jb["input_ids"], jb["pixel_values"], jb["labels"], valid_len=jb["valid_len"],
                      lora=jax.tree_util.tree_map(jnp.asarray, ad), lora_scale=lcfg.scale, lora_dropout=0.0)
    fn = tlora.make_eval_loss(lcfg.scale)
    got = fn(model, lora_from_jax(ad, device="cpu"), tbatch(padded))
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    # The padded row weighs nothing: the loss of the two real rows.
    real = fn(model, lora_from_jax(ad, device="cpu"), tbatch(batch))
    assert abs(float(got) - float(real)) <= 1e-6 * abs(float(real))


def test_merge_lora_matches_jax_and_the_unmerged_forward(setup, params, cfg):
    model, batch = setup
    lcfg = tlora.LoraConfig(**LCFG)
    ad = random_adapter(cfg, 17)
    before = [layer.qkv.weight.clone() for layer in model.llm.layers]
    merged = tlora.merge_lora(model, lora_from_jax(ad, device="cpu"), lcfg)
    assert all(torch.equal(w, layer.qkv.weight) for w, layer in zip(before, model.llm.layers))
    jmerged = jlora.merge_lora(params, jax.tree_util.tree_map(jnp.asarray, ad), jlora.LoraConfig(**LCFG))
    jqkv = np.asarray(jmerged["llm"]["layers"]["qkv"])
    for li, layer in enumerate(merged.llm.layers):
        np.testing.assert_allclose(layer.qkv.weight.numpy(), jqkv[li].T, rtol=1e-6, atol=1e-6)
        assert layer.o.weight is model.llm.layers[li].o.weight  # shared, not copied
    assert model.llm.layers[0].qkv.weight is not merged.llm.layers[0].qkv.weight
    ids, pix, valid = (torch.from_numpy(batch[k]) for k in ("input_ids", "pixel_values", "valid_len"))
    on_the_fly = tpg.forward_nocache(model, ids, pix, valid, lora=lora_from_jax(ad, device="cpu"),
                                     lora_scale=lcfg.scale)
    assert rel_err(tpg.forward_nocache(merged, ids, pix, valid), on_the_fly) < 2e-4
    from paligemma_tpu_torch import quantization

    with pytest.raises(TypeError, match="unquantized"):
        tlora.merge_lora(quantization.quantize_params(model), lora_from_jax(ad, device="cpu"), lcfg)


def _fail(*a, **k):
    raise OSError("tier disabled by the test")


@pytest.mark.parametrize("tier", ["safetensors", "npz", "pickle"])
def test_adapter_files_cross_packages(tmp_path, monkeypatch, cfg, tier):
    """The port's files read by JAX's ``load_adapter`` and JAX's read by the
    port's, at each tier (the tiers above it made to fail)."""
    ad = random_adapter(cfg, 19)
    lcfg_t, lcfg_j = tlora.LoraConfig(**LCFG), jlora.LoraConfig(**LCFG)
    if tier in ("npz", "pickle"):
        monkeypatch.setattr(checkpoint, "save_file", _fail)
        monkeypatch.setattr(safetensors.numpy, "save_file", _fail)
    if tier == "pickle":
        monkeypatch.setattr(np, "savez", _fail)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tlora.save_checkpoint_robust(lora_from_jax(ad, device="cpu"), lcfg_t, port_dir, step=3) == tier
    assert jlora.save_checkpoint_robust(jax.tree_util.tree_map(jnp.asarray, ad), lcfg_j, jax_dir, step=3) == tier
    monkeypatch.undo()
    info = json.load(open(os.path.join(port_dir, "checkpoint_info.json")))
    assert info["step"] == 3 and info["format"] == tier
    if tier == "safetensors":
        assert json.load(open(os.path.join(port_dir, "adapter_config.json"))) == json.load(
            open(os.path.join(jax_dir, "adapter_config.json")))
    by_jax = jax.tree_util.tree_map(np.asarray, jlora.load_adapter(port_dir))
    by_port = lora_to_jax(tlora.load_adapter(jax_dir, device="cpu"))
    for tree in (by_jax, by_port):
        assert tree.keys() == ad.keys()
        for got, ref in zip(leaves_by_name(tree), leaves_by_name(ad)):
            assert np.array_equal(got, ref)


def test_train_smoke_and_resume_equal_to_an_uninterrupted_run(tmp_path, setup):
    """``train`` over a list of batches (dropout on): losses, files; a run of
    2 steps resumed to 4 gives the adapter of 4 uninterrupted steps."""
    model, batch = setup
    lcfg = tlora.LoraConfig(r=2, alpha=4, dropout=0.1)
    batches = [batch] * 4
    kw = dict(lcfg=lcfg, lr=1e-2, accum_steps=2, log_every=0, save_train_state_too=True)
    full, losses = tlora.train(model, batches, save_every_n_steps=2, output_dir=str(tmp_path / "a"), **kw)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert (tmp_path / "a" / "adapter_model.safetensors").exists()
    assert (tmp_path / "a" / tlora.TRAIN_STATE_FILE).exists()
    tlora.train(model, batches[:2], save_every_n_steps=2, output_dir=str(tmp_path / "b"), **kw)
    logs = []
    resumed, losses_r = tlora.train(model, lambda epoch: batches, save_every_n_steps=0,
                                    output_dir=str(tmp_path / "b"), resume=True, logger=logs.append, **kw)
    assert logs[0] == "resumed from step 2" and len(losses_r) == 2
    assert losses_r == losses[2:]
    for a, b in zip(tlora.adapter_leaves(full), tlora.adapter_leaves(resumed)):
        assert torch.equal(a, b)
    saved = tlora.load_adapter(str(tmp_path / "b"), device="cpu")
    for a, b in zip(tlora.adapter_leaves(saved), tlora.adapter_leaves(resumed)):
        assert torch.equal(a, b)


def test_resume_mid_accumulation_equals_an_uninterrupted_run(tmp_path, setup):
    """Accumulation 3, the train state saved after 2 micro-steps (the mean
    half full): resumed to 6, the losses and the adapter of 6 uninterrupted
    steps, bit for bit."""
    model, batch = setup
    other = {**batch, "labels": np.where(batch["labels"] >= 0, (batch["labels"] * 5) % 250, -100).astype(np.int32)}
    batches = [batch, other] * 3
    kw = dict(lcfg=tlora.LoraConfig(r=2, alpha=4, dropout=0.1), lr=1e-2, accum_steps=3, log_every=0,
              save_train_state_too=True)
    full, losses = tlora.train(model, batches, save_every_n_steps=0, output_dir=str(tmp_path / "a"), **kw)
    tlora.train(model, batches[:2], save_every_n_steps=2, output_dir=str(tmp_path / "b"), **kw)
    _, opt_state, step, _ = tlora.load_train_state(str(tmp_path / "b"), device="cpu")
    assert step == 2 and opt_state["mini_step"] == 2 and any(bool(t.any()) for t in opt_state["acc"])
    resumed, losses_r = tlora.train(model, batches, save_every_n_steps=0, output_dir=str(tmp_path / "b"),
                                    resume=True, logger=lambda m: None, **kw)
    assert losses_r == losses[2:]
    for a, b in zip(tlora.adapter_leaves(full), tlora.adapter_leaves(resumed)):
        assert torch.equal(a, b)


def test_train_reraises_after_three_failures_in_a_row(tmp_path, setup):
    model, batch = setup
    bad = {**batch, "labels": batch["labels"][:, :3]}  # a shape error every step
    logs = []
    with pytest.raises(ValueError, match="do not match"):
        tlora.train(model, [bad] * 5, lcfg=tlora.LoraConfig(r=2), output_dir=str(tmp_path), logger=logs.append)
    assert sum("clearing caches and skipping" in m for m in logs) == 3


def test_forward_router_matches_jax(setup, params, cfg):
    """The reference-shaped router: no cache -> the full forward with the
    shifted loss; an empty cache -> prefill; a warm cache and one token ->
    a decode step; padding and a multi-token continuation raise."""
    model, batch = setup
    ids, pix, labels = batch["input_ids"][:1], batch["pixel_values"][:1], batch["labels"][:1]
    ref = jpg.forward(params, cfg, jnp.asarray(ids), jnp.asarray(pix), labels=jnp.asarray(labels))
    got = tpg.forward(model, torch.from_numpy(ids), torch.from_numpy(pix), labels=torch.from_numpy(labels))
    assert rel_err(got["logits"], ref["logits"]) < 1e-5
    assert abs(float(got["loss"]) - float(ref["loss"])) <= 1e-5 * abs(float(ref["loss"]))
    cache = gemma.init_cache(model.cfg.text_config, 1, ids.shape[1] + 4, torch.float32, device="cpu")
    out = tpg.forward(model, torch.from_numpy(ids), torch.from_numpy(pix), kv_cache=cache)
    assert out["kv_cache"].host_length == ids.shape[1]
    assert rel_err(out["logits"][:, -1], got["logits"][:, -1]) < 1e-5
    tok = out["logits"][:, -1:].argmax(-1).to(torch.int32)
    step = tpg.forward(model, tok, kv_cache=out["kv_cache"])
    assert step["logits"].shape[1] == 1 and step["kv_cache"].host_length == ids.shape[1] + 1
    with pytest.raises(ValueError, match="one token per step"):
        tpg.forward(model, torch.from_numpy(ids[:, :2]), kv_cache=step["kv_cache"])
    with pytest.raises(AssertionError, match="cannot be padded"):
        tpg.forward(model, torch.from_numpy(ids), torch.from_numpy(pix), attention_mask=torch.zeros(ids.shape))

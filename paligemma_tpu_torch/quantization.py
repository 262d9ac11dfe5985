"""Weight quantization for the serving modes (port of
``paligemma_tpu/quantization.py``: int8, int4 and w4a8, and the int8 x int8
prefill projections).

Quantized weights are modules with buffers in ``nn.Linear``'s ``(out, in)``
layout, each with one fp32 scale per output row:

- ``QLinear`` (port of ``QTensor``): int8 ``weight`` (out, in). The tied
  embedding (V, D) becomes one too, with per-row scales, so the int8 lm_head
  is the same kernel call as every other projection.
- ``Q4Linear`` (port of ``Q4Tensor``): int4 values in [-7, 7] packed two
  per byte (``ops.quant.pack_int4``), ``packed`` (out, in/2) uint8; the
  activations stay in their dtype (``ops.quant.q4_matmul``).
- ``W4A8Linear``: the same packed int4 values, consumed with per-row int8
  activations (``ops.quant.q4a8_matmul`` / ``mlp_w4a8``).

``quantize_params`` returns a new model that shares every tensor it does not
quantize with the input model. The reference's global ``runtime.prefill_a8``
flag is an argument here, kept on each ``QLinear`` it applies to.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from paligemma_tpu_torch.ops import quant
from paligemma_tpu_torch.ops.kernels import KERNELS, KernelFns

MODES = ("int8", "int4", "w4a8")
# With prefill_a8, a QLinear call over this many positions (x.shape[-2]) or
# more takes the int8 x int8 product (the reference's runtime.a8_min_seq):
# prefill and SigLIP do, decode never does.
A8_MIN_SEQ = 32


class QLinear(nn.Module):
    """int8 weight (out, in) with fp32 per-output-row scales (out,) and an
    optional bias in the activation dtype (port of ``QTensor``).
    ``prefill_a8``: calls of at least ``A8_MIN_SEQ`` positions quantize their
    activations to int8 too (``qproj_a8``)."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor, bias=None, prefill_a8: bool = False):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", None if bias is None else bias.detach())
        self.prefill_a8 = prefill_a8


class Q4Linear(nn.Module):
    """int4 weight packed (out, in/2) uint8 with fp32 per-output-row scales
    (out,); weight-only, the activations stay in their dtype."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)


class W4A8Linear(nn.Module):
    """int4 weight packed as ``Q4Linear``'s; the activations are quantized
    to int8 per row at each call. A class of its own, so that no type check
    takes one for the other."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)


def _symmetric(w: torch.Tensor, qmax: float):
    """Per-row symmetric quantization of (out, in): (int8 values, fp32 scales).

    The scale is ``max(absmax, 1e-8)`` times the fp32 reciprocal of
    ``qmax``: the reference's quantizers are jitted, and XLA computes their
    division by the constant that way, so these are its scales to the bit."""
    wf = w.detach().float()
    scale = wf.abs().amax(dim=1).clamp_min(1e-8) * (1.0 / qmax)
    q = torch.round(wf / scale[:, None]).clamp_(-qmax, qmax).to(torch.int8)
    return q, scale


def quantize_tensor(w: torch.Tensor, bias=None, prefill_a8: bool = False) -> QLinear:
    """Symmetric int8 of an (out, in) weight, one scale per output row."""
    q, scale = _symmetric(w, 127.0)
    return QLinear(q, scale, bias, prefill_a8)


def dequantize(qt: QLinear, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (qt.weight.float() * qt.scale[:, None]).to(dtype)


def quantize_tensor_int4(w: torch.Tensor) -> Q4Linear:
    """Symmetric int4 of an (out, in) weight in the port's packing (port of
    ``quantize_tensor_int4``: its values and scales, another byte layout)."""
    q, scale = _symmetric(w, 7.0)
    return Q4Linear(quant.pack_int4(q), scale)


def quantize_tensor_w4a8(w: torch.Tensor) -> W4A8Linear:
    """Symmetric int4 of an (out, in) weight in the port's packing (port of
    ``quantize_tensor_w4a8_tiled``: same values and scales, another layout)."""
    q, scale = _symmetric(w, 7.0)
    return W4A8Linear(quant.pack_int4(q), scale)


def quantize_embed_w4(emb: torch.Tensor) -> W4A8Linear:
    """The tied lm_head at 4 bits: per-vocab-row int4 of the (V, D)
    embedding. It serves only the lm_head product; lookups keep the int8
    table. The port's layout needs no vocab padding."""
    return quantize_tensor_w4a8(emb)


def qproj(x: torch.Tensor, qt: QLinear, fns: KernelFns = KERNELS) -> torch.Tensor:
    """x (..., T, in) @ int8 weight, rescaled per output channel, in x.dtype;
    with ``qt.prefill_a8``, calls of T >= ``A8_MIN_SEQ`` go to ``qproj_a8``
    (a static decision on the shape, as the reference's trace-time gate)."""
    if qt.prefill_a8 and x.shape[-2] >= A8_MIN_SEQ:
        return qproj_a8(x, qt, fns)
    return fns.q8(x, qt.weight, qt.scale)


def qproj_a8(x: torch.Tensor, qt: QLinear, fns: KernelFns = KERNELS) -> torch.Tensor:
    """x quantized to int8 per position, an exact int8 x int8 product, then
    ``(acc * xs) * scale`` in x.dtype (``ops.quant.a8_matmul``)."""
    return fns.a8(x, qt.weight, qt.scale)


@torch.no_grad()
def quantize_params(
    model, llm_only: bool = True, mode: str = "int8", lm_head_w4: bool = False,
    prefill_a8: bool = False,
):
    """A quantized copy of a ``PaliGemma`` (the input is left as it is).

    - ``mode="int8"``: every decoder projection (qkv, o, gate_up, down) and
      the tied embedding to int8.
    - ``mode="int4"``: every decoder projection to int4 weight-only
      (``Q4Linear``, ``ops.quant.q4_matmul`` for prefill and decode alike);
      the embedding to int8 (the lookup needs whole rows; the lm_head is
      ``q8`` with fp32 out).
    - ``mode="w4a8"``: qkv and o to int8; gate_up and down to int4 for the
      fused MLP of calls up to ``ops.quant.MLP_FUSED_MAX_ROWS`` rows, with
      int8 companions (``gate_up_i8``, ``down_i8``) for larger calls; the
      embedding to int8 plus a 4-bit copy for the lm_head (``embed_w4``).
    - ``lm_head_w4`` (w4a8 only): route lm_head calls of up to 64 rows
      through the 4-bit copy (the reference's ``runtime.lm_head_w4``), kept
      on the model as ``model.llm.lm_head_w4``.
    - ``prefill_a8`` (the reference's ``runtime.prefill_a8``): every int8
      projection that goes through ``qproj`` (the decoder's, w4a8's
      companions, and with ``llm_only=False`` SigLIP's and the projector's)
      takes the int8 x int8 product for calls of ``A8_MIN_SEQ`` positions or
      more. The lm_head never does.
    - ``llm_only=False`` also quantizes the vision tower's qkv/o/fc1/fc2 and
      the projector to int8 (biases stay in the model's dtype).
    """
    if mode not in MODES:
        raise ValueError(f"quantize_params: mode {mode!r} is not supported (choose from {MODES})")
    if lm_head_w4 and mode != "w4a8":
        raise ValueError("quantize_params: lm_head_w4 needs mode='w4a8'")
    shared = {id(t): t for t in model.state_dict(keep_vars=True).values()}
    out = copy.deepcopy(model, memo=shared)

    def int8(w, bias=None):
        return quantize_tensor(w, bias, prefill_a8)

    llm = out.llm
    for layer in llm.layers:
        if mode == "int4":
            for name in ("qkv", "o", "gate_up", "down"):
                setattr(layer, name, quantize_tensor_int4(getattr(layer, name).weight))
            continue
        gu, dn = layer.gate_up.weight, layer.down.weight
        layer.qkv, layer.o = int8(layer.qkv.weight), int8(layer.o.weight)
        if mode == "int8":
            layer.gate_up, layer.down = int8(gu), int8(dn)
        else:
            layer.gate_up, layer.down = quantize_tensor_w4a8(gu), quantize_tensor_w4a8(dn)
            layer.gate_up_i8, layer.down_i8 = int8(gu), int8(dn)
    emb = llm.embed
    del llm.embed
    llm.embed = quantize_tensor(emb)
    if mode == "w4a8":
        llm.embed_w4 = quantize_embed_w4(emb)
    llm.lm_head_w4 = lm_head_w4

    if not llm_only:
        for layer in out.vision.layers:
            for name in ("qkv", "o", "fc1", "fc2"):
                lin = getattr(layer, name)
                setattr(layer, name, int8(lin.weight, lin.bias))
        out.projector = int8(out.projector.weight, out.projector.bias)
    return out


def params_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of the model."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())

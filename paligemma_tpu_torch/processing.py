"""PaliGemma processor (port of ``paligemma_tpu/processing.py``).

Registers the ``<image>`` token plus 1024 ``<locXXXX>`` and 128 ``<segXXX>``
tokens, templates prompts as ``"<image>" * N + BOS + prompt + "\\n"`` and
preprocesses images with PIL (bicubic resize -> x/255 -> (x-0.5)/0.5 ->
CHW). Returns numpy arrays; the caller moves them to its device.
``ByteTokenizer`` is a dependency-free stand-in for the Gemma tokenizer; any
HF ``AutoTokenizer`` satisfies the same protocol.

The on-device half of the serving path: ``raw_uint8=True`` stops after the
PIL resize (uint8 CHW, one byte a pixel to upload), and the rescale and
normalize run on the device as a per-channel gather through ``pixel_lut``
(``apply_pixel_lut``, equal to the host pipeline by construction) or as
the subtract-then-scale affine (``apply_pixel_affine``), which a consumer
takes only after checking it against the gather on its own device.
``preprocess`` is the counterpart of the reference's ``preprocess_jit``:
the whole pipeline on tensors, with ``jax.image.resize``'s antialiased
Keys bicubic.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

IMAGENET_STANDARD_MEAN = [0.5, 0.5, 0.5]
IMAGENET_STANDARD_STD = [0.5, 0.5, 0.5]
IMAGE_TOKEN = "<image>"


def add_image_tokens_to_prompt(
    prefix_prompt: str, bos_token: str, image_seq_len: int, image_token: str
) -> str:
    return f"{image_token * image_seq_len}{bos_token}{prefix_prompt}\n"


def resize(image, size: Tuple[int, int], resample=None):
    """PIL resize to (height, width)."""
    height, width = size
    return image.resize((width, height), resample=resample)


def rescale(image: np.ndarray, scale: float, dtype=np.float32) -> np.ndarray:
    return (image * scale).astype(dtype)


def normalize(image: np.ndarray, mean: Iterable[float], std: Iterable[float]) -> np.ndarray:
    mean = np.array(mean, dtype=image.dtype)
    std = np.array(std, dtype=image.dtype)
    return (image - mean) / std


def process_images(
    images: Sequence,
    size: Tuple[int, int],
    resample=Image.Resampling.BICUBIC,
    rescale_factor: float = 1 / 255.0,
    image_mean=IMAGENET_STANDARD_MEAN,
    image_std=IMAGENET_STANDARD_STD,
) -> List[np.ndarray]:
    """resize -> np.array -> x * 1/255 -> (x - mean) / std -> HWC to CHW."""
    out = []
    for image in images:
        arr = np.array(resize(image, size=size, resample=resample))
        arr = normalize(rescale(arr, scale=rescale_factor), mean=image_mean, std=image_std)
        out.append(arr.transpose(2, 0, 1))
    return out


def process_images_uint8(images: Sequence, size: Tuple[int, int],
                         resample=Image.Resampling.BICUBIC) -> List[np.ndarray]:
    """The resize half of ``process_images``: PIL resize -> uint8 CHW. The
    rescale and normalize follow on the device (``apply_pixel_lut``)."""
    return [np.asarray(resize(image, size=size, resample=resample), dtype=np.uint8).transpose(2, 0, 1)
            for image in images]


def pixel_lut(rescale_factor: float = 1 / 255.0, image_mean=IMAGENET_STANDARD_MEAN,
              image_std=IMAGENET_STANDARD_STD) -> np.ndarray:
    """(3, 256) fp32 table: ``lut[c, v]`` is the host pipeline's output for
    byte ``v`` in channel ``c``, computed by ``rescale`` and ``normalize``
    themselves on a byte ramp, so a gather through it equals
    ``process_images`` bit for bit."""
    ramp = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None], (1, 256, 3))
    arr = normalize(rescale(ramp, scale=rescale_factor), mean=image_mean, std=image_std)
    return np.ascontiguousarray(arr[0].transpose(1, 0))


def apply_pixel_lut(lut: torch.Tensor, pix_u8: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 -> (B, 3, H, W) in ``lut.dtype``, a per-channel
    gather; ``lut`` is ``pixel_lut()`` cast to the consumer's dtype (a
    gather of a cast table is the cast of the gathered values)."""
    idx = pix_u8.long()
    return torch.stack([lut[c][idx[:, c]] for c in range(3)], dim=1)


def pixel_affine_coeffs(rescale_factor: float = 1 / 255.0, image_mean=IMAGENET_STANDARD_MEAN,
                        image_std=IMAGENET_STANDARD_STD) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel fp32 ``(center, mul)`` with ``(u - center) * mul`` the
    rescale/normalize affine: center = mean / rescale (127.5, exact in
    fp32), mul = rescale / std. Subtracting first leaves one fp32 rounding;
    ``u * mul + add`` would cancel at the mean pixel and can flip a bf16
    rounding. Still a candidate: a consumer checks it against
    ``apply_pixel_lut`` over the 0..255 ramp on its own device, in its own
    dtype, and keeps the gather on any mismatch."""
    mean = np.asarray(image_mean, np.float64)
    std = np.asarray(image_std, np.float64)
    center = (mean / np.float64(rescale_factor)).astype(np.float32)
    mul = (np.float64(rescale_factor) / std).astype(np.float32)
    return center, mul


def apply_pixel_affine(center: torch.Tensor, mul: torch.Tensor, pix_u8: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """(B, 3, H, W) uint8 -> (B, 3, H, W) ``out_dtype``: ``(u - center) * mul``
    in fp32, with fp32 (3,) ``center`` and ``mul`` on the pixels' device."""
    x = pix_u8.float()
    return ((x - center[None, :, None, None]) * mul[None, :, None, None]).to(out_dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel with a = -0.5 on |distance| ``x``, as
    ``jax.image.resize(method="bicubic")`` computes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of one axis of ``jax.image.resize``'s
    antialiased bicubic (``compute_weight_mat`` with translation 0): the
    kernel widened by 1 / scale when downsampling, each output's weights
    normalized to sum 1, zero where the sample lies outside the input."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def preprocess(raw_images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """On-device preprocessing (the reference's ``preprocess_jit``): (B, H0,
    W0, 3) uint8 -> (B, 3, height, width) fp32: antialiased Keys bicubic
    resize (an axis of unchanged size is left as it is), x / 255, then
    (x - mean) / std. Bicubic differs from PIL's by design; the host
    ``process_images`` is the reference's exact path."""
    x = raw_images.float()
    if x.shape[1] != height:
        x = torch.einsum("bhwc,hy->bywc", x, _resize_weights(x.shape[1], height, x.device))
    if x.shape[2] != width:
        x = torch.einsum("bywc,wx->byxc", x, _resize_weights(x.shape[2], width, x.device))
    x = x / 255.0
    mean = torch.tensor(IMAGENET_STANDARD_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STANDARD_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


class ByteTokenizer:
    """Byte-level tokenizer with the HF protocol subset the processor needs:
    ids 0..255 are raw bytes, then the special tokens in order of addition."""

    def __init__(self):
        self._token_to_id = {}
        self._id_to_token = {}
        self.bos_token = "<bos>"
        self.eos_token = "<eos>"
        self.pad_token = "<pad>"
        self._next_id = 256
        for tok in [self.pad_token, self.bos_token, self.eos_token]:
            self._add(tok)
        self.add_bos_token = True
        self.add_eos_token = False

    def _add(self, token: str) -> int:
        if token not in self._token_to_id:
            self._token_to_id[token] = self._next_id
            self._id_to_token[self._next_id] = token
            self._next_id += 1
        return self._token_to_id[token]

    @property
    def bos_token_id(self) -> int:
        return self._token_to_id[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self._token_to_id[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self._token_to_id[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return self._next_id

    def add_special_tokens(self, tokens_to_add: dict) -> int:
        toks = tokens_to_add.get("additional_special_tokens", [])
        for tok in toks:
            self._add(tok)
        return len(toks)

    def add_tokens(self, tokens: List[str]) -> int:
        for tok in tokens:
            self._add(tok)
        return len(tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._token_to_id[token]

    def _tokenize_one(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            if text[i] == "<":
                # Every special token is one "<...>" unit with no inner ">",
                # so the minimal bracketed span is the longest match.
                end = text.find(">", i)
                tid = self._token_to_id.get(text[i : end + 1]) if end != -1 else None
                if tid is not None:
                    ids.append(tid)
                    i = end + 1
                    continue
            ids.extend(text[i].encode("utf-8"))
            i += 1
        if self.add_bos_token:
            ids = [self.bos_token_id] + ids
        if self.add_eos_token:
            ids = ids + [self.eos_token_id]
        return ids

    def __call__(self, texts, padding="longest", truncation=True, return_tensors=None):
        seqs = [self._tokenize_one(t) for t in texts]
        max_len = max(len(s) for s in seqs)
        input_ids = np.full((len(seqs), max_len), self.pad_token_id, np.int32)
        attention_mask = np.zeros((len(seqs), max_len), np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            attention_mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        raw = bytearray()
        out = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if i < 256:
                raw.append(i)
                continue
            if raw:
                out.append(raw.decode("utf-8", errors="replace"))
                raw = bytearray()
            if not skip_special_tokens:
                out.append(self._id_to_token.get(int(i), ""))
        if raw:
            out.append(raw.decode("utf-8", errors="replace"))
        return "".join(out)


def _tokenizer_id_bound(processor) -> int:
    """Smallest table size covering every id the tokenizer can emit (HF's
    ``vocab_size`` excludes added tokens, so ``len(tokenizer)`` and the
    highest task-token ids count too)."""
    tok = processor.tokenizer
    bound = getattr(tok, "vocab_size", 0) or 0
    try:
        bound = max(bound, len(tok))
    except TypeError:
        pass
    bound = max(bound, processor.image_token_id + 1)
    for marker in ("<seg127>", "<loc1023>"):
        try:
            tid = tok.convert_tokens_to_ids(marker)
        except (KeyError, ValueError):
            continue
        if tid is not None and tid >= 0:
            bound = max(bound, int(tid) + 1)
    return bound


def align_config(cfg, processor):
    """``cfg`` with image_token_index = the processor's ``<image>`` id and both
    vocab sizes (composite and text config) grown to cover every id the
    tokenizer can emit."""
    v = max(cfg.text_config.vocab_size, _tokenizer_id_bound(processor))
    return dataclasses.replace(
        cfg,
        image_token_index=processor.image_token_id,
        vocab_size=max(cfg.vocab_size, v),
        text_config=dataclasses.replace(cfg.text_config, vocab_size=v),
    )


def assert_aligned(processor, cfg) -> None:
    """Raise if the processor's tokenizer and the model config disagree."""
    if processor.image_token_id != cfg.image_token_index:
        raise ValueError(
            f"processor <image> id {processor.image_token_id} != "
            f"cfg.image_token_index {cfg.image_token_index}: use align_config"
        )
    bound = _tokenizer_id_bound(processor)
    if bound > cfg.text_config.vocab_size:
        raise ValueError(
            f"tokenizer can emit ids up to {bound - 1}, out of range for the "
            f"embedding table (text vocab {cfg.text_config.vocab_size}); use align_config"
        )


class PaliGemmaProcessor:
    """Image + prompt -> {"pixel_values", "input_ids", "attention_mask"} (numpy)."""

    IMAGE_TOKEN = IMAGE_TOKEN

    def __init__(self, tokenizer, num_image_tokens: int, image_size: int):
        self.image_seq_length = num_image_tokens
        self.image_size = image_size
        tokenizer.add_special_tokens({"additional_special_tokens": [self.IMAGE_TOKEN]})
        extra = [f"<loc{i:04d}>" for i in range(1024)]
        extra += [f"<seg{i:03d}>" for i in range(128)]
        tokenizer.add_tokens(extra)
        self.image_token_id = tokenizer.convert_tokens_to_ids(self.IMAGE_TOKEN)
        tokenizer.add_bos_token = False
        tokenizer.add_eos_token = False
        self.tokenizer = tokenizer

    def __call__(self, text: List[str], images: List, padding: str = "longest",
                 truncation: bool = True, raw_uint8: bool = False) -> dict:
        """``raw_uint8``: pixel values as resized uint8 CHW, for the caller
        to finish on its device with ``apply_pixel_lut`` (equal to the
        default path's fp32 values)."""
        if len(images) != len(text):
            raise ValueError(f"Received {len(images)} images for {len(text)} prompts.")
        size = (self.image_size, self.image_size)
        pixel_values = np.stack(
            process_images_uint8(images, size) if raw_uint8 else process_images(images, size=size), axis=0
        )
        input_strings = [
            add_image_tokens_to_prompt(
                prefix_prompt=prompt,
                bos_token=self.tokenizer.bos_token,
                image_seq_len=self.image_seq_length,
                image_token=self.IMAGE_TOKEN,
            )
            for prompt in text
        ]
        inputs = self.tokenizer(input_strings, padding=padding, truncation=truncation)
        return {
            "pixel_values": pixel_values,
            "input_ids": np.asarray(inputs["input_ids"], np.int32),
            "attention_mask": np.asarray(inputs["attention_mask"], np.int32),
        }

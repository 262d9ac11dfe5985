"""Plain PyTorch reference of the served vision-language model, in float32.

A SigLIP tower, a linear projector and a decoder with the port's layer
equations (the configuration file lists them under ``assumed``): RMSNorm
scaled by (1 + w), GeGLU with tanh GELU, embeddings scaled by sqrt(d), a
tied lm_head, grouped-query attention with RoPE (half rotation), and
PaliGemma's prefix mask (the image and the prompt see each other, every
later token sees what precedes it).

It imports nothing of the program under test. It reads the weights that
the benchmark made (``archs/paligemma.py``'s names), widened to float32 or
first passed through a weight format of its own (``numerics.py``'s
``WEIGHT_FORMATS``). Products run with TF32 off. Each request runs over its
whole sequence without a cache; the decoder runs layer by layer over all
the requests of a check, each layer's weights prepared once.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

# The formats, the float32 switch and the gap are every architecture's;
# they are read here as ``vlm.<name>`` too.
from reference.numerics import ACTIVATION_FORMATS, WEIGHT_FORMATS, gaps, no_tf32  # noqa: F401

# The byte tokenizer's ids: bytes 0..255, then <pad>, <bos>, <eos>, <image>.
BOS_ID = 257
IMAGE_ID = 259


def token_ids(prompt: str, n_img: int) -> np.ndarray:
    """PaliGemma's template: ``<image>`` x n_img, BOS, the prompt's bytes, "\\n"."""
    return np.array([IMAGE_ID] * n_img + [BOS_ID] + list(prompt.encode("utf-8")) + [10], np.int64)


def pixels(image: Image.Image, size: int) -> torch.Tensor:
    """Bicubic resize to size x size, x / 255, (x - 0.5) / 0.5, CHW float32."""
    arr = np.asarray(image.resize((size, size), resample=Image.Resampling.BICUBIC), np.uint8)
    arr = (arr * (1 / 255.0)).astype(np.float32)
    arr = (arr - np.float32(0.5)) / np.float32(0.5)
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))


class Reference:
    """The reference model over a weight dict ``W`` (name -> tensor) and the
    configuration file's ``vision`` and ``text`` sizes. ``fmt`` is the
    decoder's weight format: its projections and the tied embedding pass
    through it; the tower and projector stay as made."""

    def __init__(self, W: Dict[str, torch.Tensor], vision: dict, text: dict, fmt: str = "bf16"):
        self.W, self.v, self.t = W, vision, text
        self.fmt = WEIGHT_FORMATS[fmt]
        self.act = ACTIVATION_FORMATS.get(fmt, lambda x: x)

    def _w(self, name: str, fmt: bool = False) -> torch.Tensor:
        w = self.W[name].float()
        return self.fmt(w) if fmt else w

    # -- the tower -----------------------------------------------------------

    def image_features(self, pix: torch.Tensor) -> torch.Tensor:
        """(3, H, W) -> (N_img, text hidden): SigLIP, post-LN, projector."""
        v = self.v
        d, p = v["hidden_size"], v["patch_size"]
        w_patch = self._w("vision.patch_embedding.weight").view(d, 3, p, p)
        x = F.conv2d(pix[None].float(), w_patch, self._w("vision.patch_embedding.bias"), stride=p)
        x = x.flatten(2).transpose(1, 2)[0] + self._w("vision.position_embedding")
        heads, eps = v["num_attention_heads"], v["layer_norm_eps"]
        hd = d // heads
        for i in range(v["num_hidden_layers"]):
            pre = f"vision.layers.{i}."
            y = F.layer_norm(x, (d,), self._w(pre + "ln1.weight"), self._w(pre + "ln1.bias"), eps)
            qkv = y @ self._w(pre + "qkv.weight").t() + self._w(pre + "qkv.bias")
            q, k, vv = (z.view(-1, heads, hd).transpose(0, 1) for z in qkv.split(d, dim=-1))
            att = torch.softmax((q @ k.transpose(1, 2)) * hd**-0.5, dim=-1) @ vv
            x = x + att.transpose(0, 1).reshape(-1, d) @ self._w(pre + "o.weight").t() + self._w(pre + "o.bias")
            y = F.layer_norm(x, (d,), self._w(pre + "ln2.weight"), self._w(pre + "ln2.bias"), eps)
            y = F.gelu(y @ self._w(pre + "fc1.weight").t() + self._w(pre + "fc1.bias"), approximate="tanh")
            x = x + y @ self._w(pre + "fc2.weight").t() + self._w(pre + "fc2.bias")
        x = F.layer_norm(x, (d,), self._w("vision.post_layernorm.weight"),
                         self._w("vision.post_layernorm.bias"), eps)
        return x @ self._w("projector.weight").t() + self._w("projector.bias")

    # -- the decoder ---------------------------------------------------------

    def _rms(self, x: torch.Tensor, name: str) -> torch.Tensor:
        eps = self.t["rms_norm_eps"]
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + self._w(name))

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        inv = 1.0 / (self.t["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos.float()[:, None] * inv
        ang = torch.cat([ang, ang], -1)
        x1, x2 = x.chunk(2, dim=-1)
        return x * ang.cos()[:, None] + torch.cat([-x2, x1], -1) * ang.sin()[:, None]

    def _attention(self, y: torch.Tensor, qkv_w: torch.Tensor, o_w: torch.Tensor, n_prefix: int) -> torch.Tensor:
        h, hkv, hd = (self.t[k] for k in ("num_attention_heads", "num_key_value_heads", "head_dim"))
        t = y.shape[0]
        pos = torch.arange(t, device=y.device)
        seen = (pos[None, :] <= pos[:, None]) | (pos[None, :] < n_prefix)  # (query, key)
        q, k, v = (self.act(y) @ qkv_w.t()).split([h * hd, hkv * hd, hkv * hd], -1)
        q = self._rope(q.view(t, h, hd), pos).transpose(0, 1)
        k = self._rope(k.view(t, hkv, hd), pos).transpose(0, 1).repeat_interleave(h // hkv, 0)
        v = v.view(t, hkv, hd).transpose(0, 1).repeat_interleave(h // hkv, 0)
        s = (q @ k.transpose(1, 2)) * hd**-0.5
        att = torch.softmax(s.masked_fill(~seen, float("-inf")), -1) @ v
        return self.act(att.transpose(0, 1).reshape(t, h * hd)) @ o_w.t()

    def logits(self, items: Sequence[Tuple[torch.Tensor, np.ndarray, int]]) -> List[torch.Tensor]:
        """fp32 logits (T, V) of every position of each ``(pix, ids,
        n_prefix)`` of ``items``: image tokens first, positions 0..T-1, the
        first ``n_prefix`` positions see each other, each later one sees
        every position up to its own."""
        t_cfg = self.t
        d, inter = t_cfg["hidden_size"], t_cfg["intermediate_size"]
        embed = self._w("llm.embed", fmt=True)
        xs = []
        for pix, ids, _ in items:
            n_img = int(np.argmax(ids != IMAGE_ID))  # the leading image tokens (served ids may repeat the id)
            text = torch.as_tensor(ids[n_img:], device=pix.device)
            xs.append(torch.cat([self.image_features(pix), embed[text] * math.sqrt(d)]))
        for i in range(t_cfg["num_hidden_layers"]):
            pre = f"llm.layers.{i}."
            qkv_w, o_w = self._w(pre + "qkv.weight", fmt=True), self._w(pre + "o.weight", fmt=True)
            gu_w, dn_w = self._w(pre + "gate_up.weight", fmt=True), self._w(pre + "down.weight", fmt=True)
            for j, (_, _, n_prefix) in enumerate(items):
                x = xs[j]
                x = x + self._attention(self._rms(x, pre + "input_ln.weight"), qkv_w, o_w, n_prefix)
                gate, up = (self.act(self._rms(x, pre + "post_ln.weight")) @ gu_w.t()).split(inter, -1)
                xs[j] = x + self.act(F.gelu(gate, approximate="tanh") * up) @ dn_w.t()
            del qkv_w, o_w, gu_w, dn_w
        return [self.act(self._rms(x, "llm.final_norm.weight")) @ embed.t() for x in xs]

    def served_logits(self, items: Sequence[Tuple[torch.Tensor, np.ndarray, np.ndarray]]) -> List[torch.Tensor]:
        """(n, V) fp32 logits that predict each request's served tokens, for
        ``items`` of ``(pix, prompt_ids, served)``: the prompt and the served
        tokens but the last, read at positions P-1 .. P+n-2."""
        seqs = [(pix, np.concatenate([ids, served[:-1]]).astype(np.int64), len(ids))
                for pix, ids, served in items]
        with no_tf32():
            out = self.logits(seqs)
        return [lg[p - 1:] for lg, (_, _, p) in zip(out, seqs)]

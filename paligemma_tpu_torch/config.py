"""Model configurations for the PyTorch port of PaliGemma.

The same frozen dataclasses, presets and ``config.json`` hydration as
``paligemma_tpu/config.py`` (pure Python, no framework import), so both
packages build identical geometries from one dict.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP ViT encoder hyperparameters (reference: modeling_siglip.py:7-34)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 16
    layer_norm_eps: float = 1e-6
    attention_dropout: float = 0.0
    num_image_tokens: Optional[int] = None
    projection_dim: int = 2048

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    """Gemma decoder hyperparameters (reference: modeling_gemma.py:39-71)."""

    vocab_size: int = 257152
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_bias: bool = False
    attention_dropout: float = 0.0
    pad_token_id: Optional[int] = None
    num_image_tokens: Optional[int] = None

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class PaliGemmaConfig:
    """Composite vision-language config (reference: modeling_gemma.py:74-105).

    Derives ``num_image_tokens = (image_size // patch_size)**2`` and injects
    ``projection_dim`` into the vision config, mirroring the reference's
    constructor (modeling_gemma.py:104-105).
    """

    vision_config: SiglipVisionConfig = dataclasses.field(
        default_factory=SiglipVisionConfig
    )
    text_config: GemmaConfig = dataclasses.field(default_factory=GemmaConfig)
    ignore_index: int = -100
    image_token_index: int = 256000
    vocab_size: int = 257152
    projection_dim: int = 2048
    hidden_size: int = 2048
    pad_token_id: Optional[int] = None

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "PaliGemmaConfig":
        """Build from an HF checkpoint ``config.json`` dict."""
        vision_raw = dict(raw.get("vision_config") or {})
        text_raw = dict(raw.get("text_config") or {})
        projection_dim = raw.get("projection_dim", 2048)
        pad_token_id = raw.get("pad_token_id")

        vision_fields = {f.name for f in dataclasses.fields(SiglipVisionConfig)}
        vision_kwargs = {k: v for k, v in vision_raw.items() if k in vision_fields}
        vision_kwargs["projection_dim"] = projection_dim
        vision = SiglipVisionConfig(**vision_kwargs)
        num_image_tokens = vision.num_patches
        vision = dataclasses.replace(vision, num_image_tokens=num_image_tokens)

        text_fields = {f.name for f in dataclasses.fields(GemmaConfig)}
        text_kwargs = {k: v for k, v in text_raw.items() if k in text_fields}
        text_kwargs["pad_token_id"] = pad_token_id
        text_kwargs["num_image_tokens"] = num_image_tokens
        text = GemmaConfig(**text_kwargs)

        return cls(
            vision_config=vision,
            text_config=text,
            ignore_index=raw.get("ignore_index", -100),
            image_token_index=raw.get("image_token_index", 256000),
            vocab_size=text.vocab_size,
            projection_dim=projection_dim,
            hidden_size=raw.get("hidden_size", 2048),
            pad_token_id=pad_token_id,
        )

    @classmethod
    def from_json(cls, path: str) -> "PaliGemmaConfig":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))


def paligemma_3b_pt_224() -> PaliGemmaConfig:
    """The actual google/paligemma-3b-pt-224 geometry (SigLIP-So400m + Gemma-2B)."""
    return PaliGemmaConfig.from_dict(
        {
            "image_token_index": 257152,
            "pad_token_id": 0,
            "projection_dim": 2048,
            "hidden_size": 2048,
            "vision_config": {
                "hidden_size": 1152,
                "intermediate_size": 4304,
                "num_attention_heads": 16,
                "num_hidden_layers": 27,
                "num_image_tokens": 256,
                "patch_size": 14,
                "image_size": 224,
            },
            "text_config": {
                "hidden_size": 2048,
                "intermediate_size": 16384,
                "num_attention_heads": 8,
                "num_hidden_layers": 18,
                "num_key_value_heads": 1,
                "head_dim": 256,
                "vocab_size": 257152,
            },
        }
    )


def _paligemma_3b_at(image_size: int) -> PaliGemmaConfig:
    """Same So400m + Gemma-2B towers at a different input resolution — the
    only geometry deltas across google/paligemma-3b-pt-{224,448,896} are
    image_size and the derived num_image_tokens ((size/14)^2: 256/1024/4096).
    """
    base = paligemma_3b_pt_224()
    n_img = (image_size // base.vision_config.patch_size) ** 2
    return dataclasses.replace(
        base,
        vision_config=dataclasses.replace(
            base.vision_config, image_size=image_size, num_image_tokens=n_img
        ),
    )


def paligemma_3b_pt_448() -> PaliGemmaConfig:
    """google/paligemma-3b-pt-448 geometry (1024 image tokens)."""
    return _paligemma_3b_at(448)


def paligemma_3b_pt_896() -> PaliGemmaConfig:
    """google/paligemma-3b-pt-896 geometry (4096 image tokens)."""
    return _paligemma_3b_at(896)


def tiny_config(
    vocab_size: int = 260,
    image_token_index: int = 256,
    hidden_size: int = 32,
    num_layers: int = 2,
) -> PaliGemmaConfig:
    """A miniature config for unit tests (CPU-friendly)."""
    return PaliGemmaConfig.from_dict(
        {
            "image_token_index": image_token_index,
            "pad_token_id": 0,
            "projection_dim": hidden_size,
            "hidden_size": hidden_size,
            "vision_config": {
                "hidden_size": 24,
                "intermediate_size": 48,
                "num_attention_heads": 4,
                "num_hidden_layers": num_layers,
                "patch_size": 8,
                "image_size": 32,
            },
            "text_config": {
                "hidden_size": hidden_size,
                "intermediate_size": 64,
                "num_attention_heads": 4,
                "num_key_value_heads": 2,
                "head_dim": 8,
                "num_hidden_layers": num_layers,
                "vocab_size": vocab_size,
                "max_position_embeddings": 512,
            },
        }
    )

"""Financial-document VQA dataset: a parquet manifest and a folder of page
images (port of ``paligemma_tpu/data.py``).

- Parquet columns: ``source_identifier``, ``FEATURE_page_indexes``,
  ``FEATURE_full_prompt`` (and ``template_id``, unused).
- A page image is found by the glob ``{images_folder}/{source_id}_p{page}.*``.
- Each sample is tokenized with the reference's template (image tokens,
  BOS, prompt, newline), truncated and right-padded to ``max_length``;
  labels are the text positions' ids, image tokens and padding set to
  ``ignore_index``.
- A missing or corrupt image skips ahead to the next usable row, and a
  white image stands in when none is.
- ``validate_dataset`` checks up to ``max_check`` rows' images first.
- ``batches`` yields numpy batches of static shapes (fixed ``max_length``
  and image size) and drops the ragged tail.

pandas is imported where a parquet is read.
"""
from __future__ import annotations

import glob as globlib
import os
from typing import Dict, Iterator, Optional

import numpy as np
from PIL import Image

from paligemma_tpu_torch.processing import (
    IMAGENET_STANDARD_MEAN,
    IMAGENET_STANDARD_STD,
    add_image_tokens_to_prompt,
    process_images,
)

REQUIRED_COLUMNS = (
    "source_identifier",
    "FEATURE_page_indexes",
    "FEATURE_full_prompt",
)


def _first_page_index(value) -> int:
    """FEATURE_page_indexes may be a list/array/scalar/str; take the first."""
    if isinstance(value, (list, tuple, np.ndarray)):
        return int(value[0]) if len(value) else 0
    if isinstance(value, str):
        stripped = value.strip("[] ")
        return int(float(stripped.split(",")[0])) if stripped else 0
    try:
        return int(value)
    except (TypeError, ValueError):
        return 0


def find_page_image(images_folder: str, source_id: str, page_idx: int) -> Optional[str]:
    """Glob ``{source_id}_p{page_idx}.*`` like the reference dataset."""
    matches = globlib.glob(os.path.join(images_folder, f"{source_id}_p{page_idx}.*"))
    return matches[0] if matches else None


def validate_dataset(
    parquet_file: str, images_folder: str, max_check: int = 100, logger=print
) -> Dict[str, int]:
    """Pre-scan: verify up to ``max_check`` rows' images; report missing and
    corrupted counts (reference: validate_dataset, SURVEY.md §2.9)."""
    import pandas as pd

    df = pd.read_parquet(parquet_file)
    for col in REQUIRED_COLUMNS:
        if col not in df.columns:
            raise ValueError(f"parquet missing required column {col!r}")
    missing, corrupted, checked = 0, 0, 0
    for _, row in df.head(max_check).iterrows():
        checked += 1
        page = _first_page_index(row["FEATURE_page_indexes"])
        path = find_page_image(images_folder, str(row["source_identifier"]), page)
        if path is None:
            missing += 1
            continue
        try:
            with Image.open(path) as img:
                img.verify()
        except Exception:
            corrupted += 1
    report = {"checked": checked, "missing": missing, "corrupted": corrupted}
    logger(f"dataset validation: {report}")
    return report


class FinancialImageDataset:
    """Sample access with corrupt-image fallback; yields model-ready dicts."""

    def __init__(
        self,
        parquet_file: str,
        images_folder: str,
        tokenizer,
        num_image_tokens: int,
        image_size: int = 224,
        max_length: int = 512,
        max_samples: Optional[int] = None,
        pad_token_id: Optional[int] = None,
        ignore_index: int = -100,
    ):
        import pandas as pd

        if max_length <= num_image_tokens + 2:
            # The templated sequence starts with num_image_tokens <image>
            # slots + BOS; truncating into (or below) that prefix would train
            # on misaligned inputs with zero or crashing loss. At 3B-224,
            # num_image_tokens=256 — max_length must leave room for text.
            raise ValueError(
                f"max_length={max_length} must exceed num_image_tokens+2="
                f"{num_image_tokens + 2}; the image prefix would swallow the "
                "whole sequence"
            )
        self.df = pd.read_parquet(parquet_file)
        if max_samples is not None:
            self.df = self.df.head(max_samples)
        self.images_folder = images_folder
        self.tokenizer = tokenizer
        self.num_image_tokens = num_image_tokens
        self.image_size = image_size
        self.max_length = max_length
        self.pad_token_id = (
            pad_token_id
            if pad_token_id is not None
            else getattr(tokenizer, "pad_token_id", 0)
        )
        self.ignore_index = ignore_index

    def __len__(self) -> int:
        return len(self.df)

    def _load_image(self, idx: int):
        """Corrupt-image skip-ahead with white dummy fallback (reference §2.9)."""
        for offset in range(len(self.df)):
            row = self.df.iloc[(idx + offset) % len(self.df)]
            page = _first_page_index(row["FEATURE_page_indexes"])
            path = find_page_image(
                self.images_folder, str(row["source_identifier"]), page
            )
            if path is None:
                continue
            try:
                img = Image.open(path).convert("RGB")
                return img, row
            except Exception:
                continue
        # Every image unusable: white dummy + current row.
        dummy = Image.new("RGB", (self.image_size, self.image_size), "white")
        return dummy, self.df.iloc[idx]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img, row = self._load_image(idx)
        prompt = str(row["FEATURE_full_prompt"])

        pixel_values = process_images(
            [img],
            size=(self.image_size, self.image_size),
            image_mean=IMAGENET_STANDARD_MEAN,
            image_std=IMAGENET_STANDARD_STD,
        )[0]

        templated = add_image_tokens_to_prompt(
            prompt, self.tokenizer.bos_token, self.num_image_tokens, "<image>"
        )
        enc = self.tokenizer([templated])
        ids = np.asarray(enc["input_ids"][0], np.int32)[: self.max_length]

        input_ids = np.full((self.max_length,), self.pad_token_id, np.int32)
        input_ids[: len(ids)] = ids
        valid_len = len(ids)

        # Labels: CE over text positions; image tokens + padding ignored
        # (reference: CrossEntropyLoss(ignore_index), shifted inside loss_fn).
        labels = np.full((self.max_length,), self.ignore_index, np.int32)
        labels[self.num_image_tokens : valid_len] = input_ids[
            self.num_image_tokens : valid_len
        ]
        return {
            "pixel_values": pixel_values.astype(np.float32),
            "input_ids": input_ids,
            "labels": labels,
            "valid_len": np.int32(valid_len),
        }

    def batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0, epochs: int = 1
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Static-shape numpy batches; ragged tail dropped."""
        rng = np.random.RandomState(seed)
        n = len(self)
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n - batch_size + 1, batch_size):
                samples = [self[int(i)] for i in order[start : start + batch_size]]
                yield {
                    k: np.stack([s[k] for s in samples], axis=0)
                    for k in samples[0]
                }

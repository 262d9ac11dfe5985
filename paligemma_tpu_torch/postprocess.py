"""Post-processing for PaliGemma detection / segmentation outputs (a copy of
``paligemma_tpu/postprocess.py``, which is pure Python, so that the port
imports nothing of the JAX package).

The reference registers 1024 ``<locXXXX>`` detection tokens and 128
``<segXXX>`` segmentation tokens (reference: processing_paligemma.py:63-71)
but never decodes them back into boxes. This module completes the loop, per
the PaliGemma task format (big_vision's paligemma README):

- detection: ``<loc{y0:04d}><loc{x0:04d}><loc{y1:04d}><loc{x1:04d}> label``
  per object, objects separated by " ; "; coordinates are normalized bins in
  [0, 1024) over the image, y before x,
- segmentation: the 4 loc tokens followed by 16 ``<seg{i:03d}>`` codebook
  indices (mask VQ codes; decoding the codes to pixels needs the VAE
  codebook, which the checkpoint does not ship — indices are returned as-is).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

_LOC = re.compile(r"<loc(\d{4})>")
_DETECT = re.compile(
    r"<loc(\d{4})><loc(\d{4})><loc(\d{4})><loc(\d{4})>((?:<seg\d{3}>)*)\s*([^;<]*)"
)
_SEG = re.compile(r"<seg(\d{3})>")

BINS = 1024


@dataclasses.dataclass
class Detection:
    """One detected object: normalized + absolute box, label, seg indices."""

    box_norm: Tuple[float, float, float, float]  # (y0, x0, y1, x1) in [0, 1]
    label: str
    seg_indices: Optional[List[int]] = None

    def to_absolute(self, width: int, height: int) -> Tuple[int, int, int, int]:
        """(x0, y0, x1, y1) pixel box for an image of the given size."""
        y0, x0, y1, x1 = self.box_norm
        return (
            int(round(x0 * width)),
            int(round(y0 * height)),
            int(round(x1 * width)),
            int(round(y1 * height)),
        )


def extract_detections(text: str) -> List[Detection]:
    """Parse every ``<loc>``-quad (+ optional seg codes + label) in ``text``.

    Use with ``tokenizer.decode(..., skip_special_tokens=False)`` so the loc
    tokens survive decoding.
    """
    out = []
    for m in _DETECT.finditer(text):
        y0, x0, y1, x1 = (int(m.group(i)) / BINS for i in range(1, 5))
        seg = [int(s) for s in _SEG.findall(m.group(5))] or None
        label = m.group(6).strip()
        out.append(
            Detection(box_norm=(y0, x0, y1, x1), label=label, seg_indices=seg)
        )
    return out


def strip_location_tokens(text: str) -> str:
    """Remove loc/seg tokens, leaving plain text (labels and prose)."""
    return _SEG.sub("", _LOC.sub("", text)).strip()


def format_detection_prompt(*labels: str) -> str:
    """The PaliGemma detection task prompt: ``detect a ; b ; c``."""
    return "detect " + " ; ".join(labels)


def format_segmentation_prompt(label: str) -> str:
    return f"segment {label}"

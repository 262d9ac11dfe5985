"""Token selection (port of ``paligemma_tpu/ops/sampling.py``): greedy only."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis. logits: (B, V) -> (B,) int32."""
    return logits.argmax(dim=-1).to(torch.int32)

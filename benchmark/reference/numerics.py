"""What every architecture's plain reference shares: its own weight
formats, float32 products with TF32 off, and the gap by which the output
check judges a served token.

"int8" and "int4" are symmetric per-output-row integers, weight-only;
"fp8" is per-row-scaled float8 e4m3 for the weights and for the rows of
activations that enter the decoder's products (``ACTIVATION_FORMATS``).
It imports nothing of the program under test.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def _symmetric(w: torch.Tensor, qmax: float) -> torch.Tensor:
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(w / scale).clamp(-qmax, qmax) * scale


def _fp8(w: torch.Tensor) -> torch.Tensor:
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


WEIGHT_FORMATS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "bf16": lambda w: w,
    "int8": lambda w: _symmetric(w, 127.0),
    "int4": lambda w: _symmetric(w, 7.0),
    "fp8": _fp8,
}
# Formats whose products also take their activations in them: the rows
# going into each decoder projection and the lm_head, per-row scaled.
ACTIVATION_FORMATS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {"fp8": _fp8}


class no_tf32:
    """float32 products in float32 (cuBLAS and cuDNN may otherwise take TF32)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(n,) how far each token's logit lies below the best of its row, in
    units of the row's standard deviation over the vocab."""
    best = logits.max(-1).values
    mine = logits.gather(-1, tokens[:, None].long())[:, 0]
    return (best - mine) / logits.std(-1)

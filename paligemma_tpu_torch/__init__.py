"""PyTorch port of the PaliGemma stack, with hand-written CUDA kernels for Hopper.

Sits beside the JAX reference package ``paligemma_tpu`` and imports neither
jax nor that package. The attention kernels (``ops/cuda_attention.py``,
sources in ``csrc/``) are built with nvcc at first use; a CPU tensor runs
their plain PyTorch versions.
"""

from paligemma_tpu_torch.config import (
    GemmaConfig,
    PaliGemmaConfig,
    SiglipVisionConfig,
    paligemma_3b_pt_224,
    paligemma_3b_pt_448,
    paligemma_3b_pt_896,
    tiny_config,
)

__all__ = [
    "GemmaConfig",
    "PaliGemmaConfig",
    "SiglipVisionConfig",
    "paligemma_3b_pt_224",
    "paligemma_3b_pt_448",
    "paligemma_3b_pt_896",
    "tiny_config",
]

"""Ops of the PyTorch port: norms, RoPE, attention references, sampling and the CUDA attention kernels."""

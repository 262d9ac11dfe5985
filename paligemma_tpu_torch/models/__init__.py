"""Models of the PyTorch port: SigLIP, Gemma and the PaliGemma fusion."""

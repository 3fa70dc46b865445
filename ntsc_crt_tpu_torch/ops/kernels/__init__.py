"""Hand-written CUDA kernels and their plain torch versions."""

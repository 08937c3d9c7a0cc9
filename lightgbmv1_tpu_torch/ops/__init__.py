"""Hand-written CUDA kernels, their plain PyTorch versions and their build."""

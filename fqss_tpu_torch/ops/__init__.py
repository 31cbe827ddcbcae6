"""Hand-written CUDA kernels, their plain PyTorch versions and the build that loads them."""

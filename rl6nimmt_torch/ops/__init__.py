"""Hand-written CUDA kernels (K1-K4), their plain PyTorch twins, and Philox."""

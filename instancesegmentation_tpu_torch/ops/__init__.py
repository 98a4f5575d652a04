"""Device-side ops: the separable crop-warp, heatmap rendering and the
bottleneck-chain kernel (CUDA C++ in ``csrc/``, plain PyTorch version
beside it)."""

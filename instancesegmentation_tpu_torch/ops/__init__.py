"""Device-side ops: the separable crop-warp, heatmap rendering, the
bottleneck-chain kernel and the detection ops (NMS, RoI-Align, proposal
matching), each kernel in CUDA C++ in ``csrc/`` with its plain PyTorch
version beside it."""

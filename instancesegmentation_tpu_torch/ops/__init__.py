"""Device-side ops: the separable and rotated crop-warps, heatmap rendering,
the bottleneck-chain kernel, the two-level rotated warp kernels and the
detection ops (NMS, RoI-Align, proposal matching), each kernel in CUDA C++ in
``csrc/`` with its plain PyTorch version beside it."""

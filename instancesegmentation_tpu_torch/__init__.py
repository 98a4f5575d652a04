"""instancesegmentation_tpu_torch: the PyTorch / CUDA port of the
keypoint-conditioned person instance segmentation system.

It serves the same programs as the JAX package ``instancesegmentation_tpu``
(which stays the reference), on one NVIDIA Hopper GPU:

- ``core``    device selection (the card unless the caller asks for the CPU).
- ``utils``   weight carrying between the flax variable tree and the port's
              state dict.
- ``models``  the Segment encoder-decoder as ``nn.Module``s (eval forward),
              BN folding and the algebraically folded section-6 head.
- ``ops``     the separable crop-warp, the heatmap render, the
              bottleneck-chain kernel and the detection ops (NMS, RoI-Align,
              proposal matching); each kernel is hand-written CUDA C++ for
              sm_90a (sources in ``csrc/``) with its plain PyTorch version.
- ``infer``   the instance and whole-image serving programs, the engine, the
              dynamic-batching front end and proposal-based serving (NMS,
              then one instance crop per surviving box).
- ``data``    the synthetic host batch the benchmarks and tests feed.

The package imports ``torch`` and ``numpy`` only; it never imports JAX or
the JAX package.
"""

__version__ = "0.1.0"

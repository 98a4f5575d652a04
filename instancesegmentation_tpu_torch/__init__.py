"""instancesegmentation_tpu_torch: the PyTorch / CUDA port of the
keypoint-conditioned person instance segmentation system.

It serves the same programs as the JAX package ``instancesegmentation_tpu``
(which stays the reference), on one NVIDIA Hopper GPU:

- ``core``    device selection (the card unless the caller asks for the CPU),
              records, the image reader and writer (``imread`` /
              ``imwrite``: every format cv2 reads but AVIF (and JPEG
              2000's HTJ2K and Part 2 forms), and every one it writes but
              WebP, JPEG 2000 and AVIF, with EXIF
              orientation, as ``cv2.imread`` / ``cv2.imwrite``), the
              codecs behind them, cv2's box and circle drawing, mask
              rasterisation and RLE codecs, mask AP
              (``core/evaluation.py``), and record-level affine augmentation
              (``core/augment.py``, ``cv2.warpAffine``'s arithmetic).
- ``utils``   weight carrying between the flax variable tree and the port's
              state dict, ``torch.profiler`` traces and step timing, debug
              summaries.
- ``models``  the Segment encoder-decoder as ``nn.Module``s (eval and train
              forward), BN folding, the algebraically folded section-6
              head (serving fold and differentiable training fold), the
              space-to-depth and keypoint-patch folded stems, and int8
              post-training quantisation.
- ``ops``     the separable and rotated crop-warps, the heatmap render, the
              bottleneck-chain kernel, the two-level rotated warp kernels and
              the detection ops (NMS, RoI-Align, proposal matching); each
              kernel is hand-written CUDA C++ for sm_90a (sources in
              ``csrc/``) with its plain PyTorch version; ``ops/native`` the
              host C++ RLE IoU of mask AP and the JPEG decoder and
              encoder.
- ``infer``   the instance and whole-image serving programs, the engine, the
              dynamic-batching front end, proposal-based serving (NMS,
              then one instance crop per surviving box) and the inference
              command (``python -m instancesegmentation_tpu_torch.infer``).
- ``eval``    mask IoU and mask AP over a dataset
              (``python -m instancesegmentation_tpu_torch.eval``).
- ``data``    the preprocessing program of training (augmentation draws,
              rotated/separable crop warp, photometric augmentations,
              heatmaps), the threaded and the worker-process loaders, the
              synthetic host batch, and the dataset converters (COCO,
              OCHuman, Supervisely -> common format).
- ``train``   the training configuration, the train state (model + Adam),
              the train and eval steps, ISEG checkpoints as a file or a
              directory, and the trainer
              (``python -m instancesegmentation_tpu_torch.train``).
- ``parallel`` data parallelism over ``torch.distributed``: process groups
              (``multihost``), the data-parallel train and eval steps with
              synchronised BatchNorm, and the replicated inference engine.

The package imports ``torch`` and ``numpy`` only; it never imports JAX or
the JAX package.
"""

__version__ = "0.1.0"

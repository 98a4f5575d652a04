"""Post-training int8 quantisation (PTQ): calibration of the convs' input
scales.

Port of ``instancesegmentation_tpu/models/quantize.py``.  The quantised conv
is ``ops/int8_conv.py``, switched per conv by ``Segment.set_quant``:

- "calibrate": float math; every conv records the abs-max of its input;
- "int8": symmetric per-tensor input / per-output-channel weight int8,
  s8 x s8 -> s32 convs, dequantised in the epilogue, on all 76 convs;
- "int8_mxu": int8 only on the 6 spatial (k >= 2) non-grouped convs.

Calibration records every conv, so one set of scales serves both int8
modes.  The scales live outside the state dict, as a dict keyed by the
conv's module path (``{"init_conv.layer1.conv": amax, ...}``; JAX's separate
``quant`` collection, carried both ways by ``utils/weights.py``), so float
checkpoints stay as they are and quantisation is a serving-time decision:

    scales = calibrate_on_dataset(variables, dataset_dir)
    engine = InferenceEngine(variables, in_channels=20, size=480, quant=scales)

Calibration runs the unfolded model in float32 through its layer modules (no
chain kernel), on ``cuda:0`` unless ``device`` says otherwise.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from instancesegmentation_tpu_torch.core.device import pick_device
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.utils.weights import port_state_dict


def calibrate(model: Segment, variables: Optional[dict], batches) -> dict[str, float]:
    """Run calibration ``batches`` through ``model`` in "calibrate" mode and
    return the input abs-max of every conv (the running maximum over the
    batches), keyed by module path.

    ``variables`` (flax-layout variables or a port state dict; None keeps the
    model's weights) is loaded first.  ``batches`` yields ``images`` or
    ``(images, heatmaps)`` (NHWC arrays or tensors) matching the model's
    ``in_channels``; they are moved to the model's device.  The model is left
    in the "off" mode.
    """
    if variables is not None:
        model.load_state_dict(port_state_dict(variables))
    device = model.bottle6_1.weight.device
    model.set_quant("calibrate")
    seen = 0
    try:
        with torch.inference_mode():
            for batch in batches:
                images, heatmaps = batch if isinstance(batch, (tuple, list)) else (batch, None)
                model(torch.as_tensor(images).to(device),
                      None if heatmaps is None else torch.as_tensor(heatmaps).to(device))
                seen += 1
        if not seen:
            raise ValueError("calibrate() needs at least one batch")
        return model.calibration_scales()
    finally:
        model.set_quant("off")


def _calibrate_model(in_channels: int, device) -> Segment:
    # float32: the abs-max must see the true activation range, not values
    # rounded to bfloat16
    return Segment(in_channels).to(device=device, memory_format=torch.channels_last).eval()


def calibrate_on_dataset(variables: dict, dataset_dir: str, in_channels: int = 20,
                         size: int = 480, batches: int = 2, batch_size: int = 8,
                         device=None) -> dict[str, float]:
    """Calibrate over the first ``batches`` instance batches of a
    common-format dataset, through the serving preprocess (crop warp and
    heatmap render, every augmentation off, so nothing is drawn): the
    activation ranges the quantised program will see."""
    from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
    from instancesegmentation_tpu_torch.data.pipeline import (
        AugmentConfig,
        batch_iterator,
        batch_to,
        draw_augment,
        preprocess_batch,
    )

    device = pick_device(device)
    model = _calibrate_model(in_channels, device)
    aug = AugmentConfig(out_size=(size, size))
    stream = batch_iterator(InstanceCommonDataset(dataset_dir), batch_size, shuffle=False,
                            epochs=1, drop_last=False)

    def gen():
        with contextlib.closing(stream):
            for k, batch in enumerate(stream):
                if k >= batches:
                    break
                images, heatmaps, _ = preprocess_batch(
                    batch_to(batch, device), draw_augment(batch["image"].shape[0], aug), aug)
                yield (images, heatmaps) if in_channels > 3 else images

    return calibrate(model, variables, gen())


def calibrate_on_images(variables: dict, images: list, in_channels: int = 3, size: int = 512,
                        device=None) -> dict[str, float]:
    """Calibrate on raw RGB uint8 images (whole-image serving): cv2's uint8
    INTER_LINEAR resize to ``size`` and the engine's normalise, on the host;
    a conditioned checkpoint sees the zero heatmaps whole-image mode serves
    with."""
    from instancesegmentation_tpu_torch.infer.pipeline import resize

    if not images:
        raise ValueError("calibrate_on_images() needs at least one image")
    device = pick_device(device)
    model = _calibrate_model(in_channels, device)
    batch = torch.stack([resize(torch.from_numpy(np.ascontiguousarray(img)), (size, size))
                         for img in images])
    x = batch / 127.5 - 1.0
    if in_channels > 3:
        hm = torch.zeros(x.shape[:3] + (in_channels - 3,), dtype=x.dtype)
        return calibrate(model, variables, [(x, hm)])
    return calibrate(model, variables, [x])

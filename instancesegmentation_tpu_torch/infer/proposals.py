"""Host helpers of instance serving: one request row per (image, box,
keypoints), and the mapping of a canvas-frame mask back to the request.

Port of the host helpers of ``instancesegmentation_tpu/infer/proposals.py``
(``_place_on_canvas``, ``_instance_rows``, ``instance_request_row``,
``finish_instance_request``, ``_mask_score``).  The ``cv2.resize`` calls
there are ``infer.pipeline.resize`` here.
"""
from __future__ import annotations

import numpy as np
import torch

from instancesegmentation_tpu_torch.infer.pipeline import resize, to_u8


def _place_on_canvas(image_rgb: np.ndarray, canvas: int):
    """Resize-to-fit + top-left place one image on the square canvas.

    Returns (canvas_img [C,C,3] u8, scale, (eh, ew)) where scale maps
    original -> canvas coordinates (1.0 when the image already fits).
    """
    h, w = image_rgb.shape[:2]
    scale = 1.0
    img = image_rgb
    if max(h, w) > canvas:
        scale = canvas / max(h, w)
        out_hw = (int(h * scale), int(w * scale))
        img = to_u8(resize(torch.from_numpy(np.ascontiguousarray(img)), out_hw)).numpy()
    eh, ew = img.shape[:2]
    canvas_img = np.zeros((canvas, canvas, 3), dtype=np.uint8)
    canvas_img[:eh, :ew] = img
    return canvas_img, scale, (eh, ew)


def _instance_rows(canvas_img, scale, eh, ew, boxes_kept, kps_kept, canvas):
    """Per-proposal host-batch rows for ``predict_instances``: the proposal
    box doubles as centring and crop window; keypoints (if any) are scaled
    into the canvas frame."""
    b = boxes_kept.shape[0]
    if kps_kept is None:
        kps = np.zeros((b, 17, 3), np.float32)  # unconditioned
    else:
        kps = np.asarray(kps_kept, np.float32).reshape(b, 17, 3).copy()
        kps[..., :2] *= scale
    kept_boxes = boxes_kept * scale
    return {
        "image": np.broadcast_to(canvas_img, (b,) + canvas_img.shape),
        "mask": np.zeros((b, canvas, canvas), dtype=np.uint8),
        "image_hw": np.tile(np.asarray([eh, ew], np.float32), (b, 1)),
        "obj_box": kept_boxes,
        "mask_box": kept_boxes,
        "mask_valid": np.ones((b,), bool),
        "keypoints": kps,
    }


def instance_request_row(image_rgb: np.ndarray, box, keypoints, canvas: int = 640):
    """One serving-side instance request -> (row, meta).

    ``row`` is a single host-batch row (no leading batch dim) in the
    ``predict_instances`` layout; ``meta`` carries what
    ``finish_instance_request`` needs to map the canvas-frame mask back to
    the request's own resolution.
    """
    image_rgb = np.asarray(image_rgb)
    canvas_img, scale, (eh, ew) = _place_on_canvas(image_rgb, canvas)
    boxes = np.asarray(box, np.float32).reshape(1, 4)
    kps = None
    if keypoints is not None:
        kps = np.asarray(keypoints, np.float32).reshape(1, 17, 3)
    rows = _instance_rows(canvas_img, scale, eh, ew, boxes, kps, canvas)
    row = {k: np.asarray(rows[k][0]) for k in rows}
    meta = {"scale": scale, "eff_hw": (eh, ew),
            "orig_hw": tuple(image_rgb.shape[:2])}
    return row, meta


def finish_instance_request(canvas_mask: np.ndarray, prob_map: np.ndarray,
                            meta: dict, threshold: float):
    """Map one canvas-frame mask back to the request resolution and score
    it; returns (mask_u8, mask_score)."""
    eh, ew = meta["eff_hw"]
    h, w = meta["orig_hw"]
    mask = canvas_mask[:eh, :ew]
    if meta["scale"] != 1.0:
        mask = resize(torch.from_numpy(np.ascontiguousarray(mask)), (h, w),
                      "nearest").to(torch.uint8).numpy()
    return mask, _mask_score(prob_map, threshold)


def _mask_score(prob_map: np.ndarray, threshold: float) -> float:
    """Mean predicted probability inside the predicted mask."""
    fg = prob_map > threshold
    return float(prob_map[fg].mean()) if fg.any() else 0.0

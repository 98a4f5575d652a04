"""Proposal-based multi-instance serving, and the host helpers of instance
serving: one request row per (image, box, keypoints), and the mapping of a
canvas-frame mask back to the request.

Port of ``instancesegmentation_tpu/infer/proposals.py``.  Given an image and
candidate person boxes (from any detector, or ground-truth boxes), the path
is NMS on the engine's device (``ops/nms.py``: the CUDA kernel on the card,
the plain version on the CPU), one instance crop per surviving box through
``InferenceEngine.predict_instances``, and the inverse mapping of each mask
to the image's resolution.  ``iter_segment_proposals`` packs the crops of
consecutive images into shared dispatches.  The ``cv2.resize`` calls of the
JAX module are ``infer.pipeline.resize`` here; there is no NMS backend
switch: the device decides, kernel or raise.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from instancesegmentation_tpu_torch.infer.pipeline import MAX_BUCKET, resize, to_u8
from instancesegmentation_tpu_torch.ops.nms import nms


def _nms_keep(boxes: np.ndarray, scores: np.ndarray, nms_threshold: float,
              max_instances: int, device) -> np.ndarray:
    """NMS on ``device`` -> indices of the surviving boxes in descending
    score order (callers index boxes, scores and keypoints with them)."""
    n = boxes.shape[0]
    idx, valid = nms(torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device),
                     nms_threshold, max_outputs=min(max_instances, n))
    idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
    if int(valid.sum()) >= max_instances and n > max_instances:
        # no silent caps: the output slots may be clipping boxes that would
        # otherwise survive
        print(f"segment_proposals: max_instances={max_instances} cap hit "
              f"({n} proposals in); raise max_instances if recall matters")
    return idx[valid]


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


def segment_proposals(engine, image_rgb: np.ndarray, boxes: Sequence[Sequence[float]],
                      scores: Sequence[float], keypoints: Optional[np.ndarray] = None,
                      nms_threshold: float = 0.7, max_instances: int = 16,
                      canvas: int = 640) -> list[dict]:
    """Segment every surviving proposal of one image.

    ``keypoints`` is an optional [N, 17, 3] (x, y, vis) array aligned with
    ``boxes`` in the image's own coordinates; the rows that survive NMS
    condition the model as training does.  Returns a list of ``{"box",
    "score", "mask_score", "mask"}`` dicts; masks are uint8 0/255 at the
    image's resolution.
    """
    request = {"image": image_rgb, "boxes": boxes, "scores": scores, "keypoints": keypoints}
    return list(iter_segment_proposals(engine, [request], nms_threshold=nms_threshold,
                                       max_instances=max_instances, canvas=canvas))[0]


def iter_segment_proposals(engine, requests: Iterable[dict], nms_threshold: float = 0.7,
                           max_instances: int = 16, canvas: int = 640,
                           batch_cap: int = MAX_BUCKET) -> Iterator[list[dict]]:
    """Proposal segmentation over a stream of images, with the crops of
    consecutive images packed into shared dispatches.

    ``requests`` yields ``{"image", "boxes", "scores", "keypoints"?, "nms"?}``
    dicts; one result list per request is yielded, in input order.  Crops
    are buffered until at least ``batch_cap`` rows are pending, then run in
    one ``predict_instances`` call (which chunks above ``MAX_BUCKET``); the
    rest run at the end.  ``"nms": False`` marks ground-truth boxes: each is
    a distinct instance (two occluded people may share a box), so none is
    suppressed; they are taken in input order up to ``max_instances``.
    """
    pending_rows: list[dict] = []    # per-crop rows not yet run
    pending_images: list[dict] = []  # per-image metadata, input order

    def _dispatch():
        if not pending_rows:
            return
        batch = {k: np.stack([r["row"][k] for r in pending_rows])
                 for k in ("image", "mask", "image_hw", "obj_box", "mask_box",
                           "mask_valid", "keypoints")}
        probs, canvas_masks = engine.predict_instances(batch)
        for i, r in enumerate(pending_rows):
            r["prob"] = probs[i, ..., 0]
            r["canvas_mask"] = canvas_masks[i]
        pending_rows.clear()

    def _finish(meta) -> list[dict]:
        out = []
        for r in meta["rows"]:
            mask, mask_score = finish_instance_request(r["canvas_mask"], r["prob"], meta,
                                                       engine.threshold)
            out.append({"box": r["box"].tolist(), "score": float(r["score"]),
                        "mask_score": mask_score, "mask": mask})
        return out

    for req in requests:
        boxes = np.asarray(req["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(req["scores"], np.float32).reshape(-1)
        kps = req.get("keypoints")
        if boxes.shape[0] == 0:
            pending_images.append({"rows": []})
        else:
            if req.get("nms", True):
                keep = _nms_keep(boxes, scores, nms_threshold, max_instances, engine.device)
            else:
                keep = np.arange(boxes.shape[0])
                if boxes.shape[0] > max_instances:
                    print(f"segment_proposals: max_instances={max_instances} cap hit "
                          f"({boxes.shape[0]} GT boxes in); raise max_instances if "
                          "recall matters")
                    keep = keep[:max_instances]
            image_rgb = np.asarray(req["image"])
            canvas_img, scale, (eh, ew) = _place_on_canvas(image_rgb, canvas)
            kept_kps = None
            if kps is not None:
                kept_kps = np.asarray(kps, np.float32).reshape(-1, 17, 3)[keep]
            rows_batch = _instance_rows(canvas_img, scale, eh, ew, boxes[keep], kept_kps,
                                        canvas)
            rows = [{"row": {key: rows_batch[key][i] for key in rows_batch},
                     "box": boxes[k], "score": scores[k]} for i, k in enumerate(keep)]
            pending_images.append({"rows": rows, "scale": scale, "eff_hw": (eh, ew),
                                   "orig_hw": image_rgb.shape[:2]})
            pending_rows.extend(rows)

        if len(pending_rows) >= batch_cap:
            _dispatch()
        # yield every image whose rows are all computed: memory stays flat
        # and the output keeps the input order
        while pending_images and all("prob" in r for r in pending_images[0]["rows"]):
            yield _finish(pending_images.pop(0))

    _dispatch()
    while pending_images:
        yield _finish(pending_images.pop(0))

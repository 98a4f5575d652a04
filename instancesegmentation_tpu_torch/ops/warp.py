"""Fused instance-crop warp (the separable half): the reference's
centring translate + crop-and-pad + resize as ONE scale-and-translate per
sample, batched.

Port of ``instancesegmentation_tpu/ops/warp.py`` (``WarpParams``,
``center_translation``, ``clipped_mask_box``, ``instance_warp_params``,
``_axis_weights``, ``warp_image``, ``warp_points``).  Every function takes a
leading batch dimension; the JAX package vmaps the per-sample versions.

  src = (u + 0.5) * scale - 0.5 + offset

is sampled with explicit separable bilinear weight matrices, so positions
outside the source read an implicit zero (the reference's black fill), and
``src_lo``/``src_hi`` zero the source pixels that the centring translation
cut off the canvas.  The two contractions are ``torch.matmul``s.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class WarpParams(NamedTuple):
    """Per-sample output->source mapping ``src = (u+0.5)*scale - 0.5 + offset``.

    scale, offset: [B, 2] ordered (y, x).  src_lo, src_hi: optional [B, 2]
    valid source interval per axis; source pixels outside ``[lo, hi)``
    contribute zero.
    """

    scale: torch.Tensor
    offset: torch.Tensor
    src_lo: Optional[torch.Tensor] = None
    src_hi: Optional[torch.Tensor] = None


def center_translation(obj_box: torch.Tensor, image_hw: torch.Tensor):
    """The reference's centring translation (ty, tx), each [B]; ``int()``
    truncates toward zero."""
    h, w = image_hw[:, 0], image_hw[:, 1]
    tx = torch.trunc(w / 2.0 - (obj_box[:, 0] + obj_box[:, 2]) / 2.0)
    ty = torch.trunc(h / 2.0 - (obj_box[:, 1] + obj_box[:, 3]) / 2.0)
    return ty, tx


def clipped_mask_box(mask: torch.Tensor, ty_tx, image_hw: torch.Tensor):
    """Tight box (source coords, exclusive upper) of the mask pixels that
    survive the centring translation, and a validity flag.

    mask [B, H, W] -> (boxes [B, 4] xyxy float32, valid [B] bool).
    """
    ty, tx = (t.view(-1, 1, 1) for t in ty_tx)
    h = image_hw[:, 0].view(-1, 1, 1)
    w = image_hw[:, 1].view(-1, 1, 1)
    ch, cw = mask.shape[1], mask.shape[2]
    ys = torch.arange(ch, dtype=torch.float32, device=mask.device).view(1, -1, 1)
    xs = torch.arange(cw, dtype=torch.float32, device=mask.device).view(1, 1, -1)
    on = ((mask > 0) & (xs + tx >= 0) & (xs + tx < w)
          & (ys + ty >= 0) & (ys + ty < h))
    valid = on.flatten(1).any(dim=1)
    big = torch.tensor(float(max(ch, cw)), device=mask.device)
    neg = torch.tensor(-1.0, device=mask.device)
    xs, ys = xs.expand_as(on), ys.expand_as(on)
    x0 = torch.where(on, xs, big).flatten(1).amin(dim=1)
    y0 = torch.where(on, ys, big).flatten(1).amin(dim=1)
    x1 = torch.where(on, xs, neg).flatten(1).amax(dim=1) + 1.0
    y1 = torch.where(on, ys, neg).flatten(1).amax(dim=1) + 1.0
    return torch.stack([x0, y0, x1, y1], dim=1), valid


def instance_warp_params(obj_box, mask_box, image_hw, out_hw, pad: int = 16,
                         mask_valid=None) -> WarpParams:
    """The fused warp of each sample (all inputs float [B, ...]).

    obj_box [B,4] xyxy annotation box (drives the centring translation);
    mask_box [B,4] xyxy tight instance-mask box in original coordinates
    (x1/y1 exclusive); image_hw [B,2]; mask_valid [B] bool, False falls back
    to the whole image as the crop box.
    """
    h, w = image_hw[:, 0], image_hw[:, 1]
    ty, tx = center_translation(obj_box, image_hw)
    whole = torch.stack([0.0 - tx, 0.0 - ty, w - tx, h - ty], dim=1)
    mb = mask_box if mask_valid is None else torch.where(
        mask_valid[:, None], mask_box, whole)
    zero = torch.zeros_like(w)
    bx0 = torch.clamp(mb[:, 0] + tx, zero, w)
    by0 = torch.clamp(mb[:, 1] + ty, zero, h)
    bx1 = torch.clamp(mb[:, 2] + tx, zero, w)
    by1 = torch.clamp(mb[:, 3] + ty, zero, h)

    # crop window = box +- pad
    wx0, wy0 = bx0 - pad, by0 - pad
    wx1, wy1 = bx1 + pad, by1 + pad

    out_h, out_w = out_hw
    scale = torch.stack([(wy1 - wy0) / out_h, (wx1 - wx0) / out_w], dim=1)
    offset = torch.stack([wy0 - ty, wx0 - tx], dim=1)
    src_lo = torch.stack([torch.clamp_min(-ty, 0.0), torch.clamp_min(-tx, 0.0)], dim=1)
    src_hi = torch.stack([torch.minimum(h, h - ty), torch.minimum(w, w - tx)], dim=1)
    return WarpParams(scale, offset, src_lo, src_hi)


def _axis_weights(scale, offset, in_size: int, out_size: int, lo=None, hi=None):
    """Bilinear (hat) sampling weights [B, out_size, in_size]: row u holds
    the weights of the source pixels for output pixel u at
    ``src = (u+0.5)*scale - 0.5 + offset``; out-of-range source positions
    have no weight (black fill), and ``lo``/``hi`` zero source pixels outside
    the valid interval."""
    dev = scale.device
    u = torch.arange(out_size, dtype=torch.float32, device=dev).view(1, -1, 1)
    grid = torch.arange(in_size, dtype=torch.float32, device=dev).view(1, 1, -1)
    src = (u + 0.5) * scale.view(-1, 1, 1) - 0.5 + offset.view(-1, 1, 1)
    weights = torch.clamp_min(1.0 - torch.abs(src - grid), 0.0)
    if lo is not None:
        keep = (grid >= lo.view(-1, 1, 1)) & (grid < hi.view(-1, 1, 1))
        weights = weights * keep.to(weights.dtype)
    return weights


def warp_image(image: torch.Tensor, params: WarpParams, out_hw) -> torch.Tensor:
    """Sample float images [B, H, W, C] through ``params`` to
    [B, out_h, out_w, C] in float32: two matmuls with the explicit
    separable bilinear weight matrices."""
    out_h, out_w = out_hw
    b, h, w, c = image.shape
    lo = (None, None) if params.src_lo is None else params.src_lo.unbind(1)
    hi = (None, None) if params.src_hi is None else params.src_hi.unbind(1)
    wy = _axis_weights(params.scale[:, 0], params.offset[:, 0], h, out_h, lo[0], hi[0])
    wx = _axis_weights(params.scale[:, 1], params.offset[:, 1], w, out_w, lo[1], hi[1])
    tmp = torch.matmul(wy, image.float().reshape(b, h, w * c))  # [B, oh, W*C]
    tmp = tmp.view(b, out_h, w, c).transpose(1, 2).reshape(b, w, out_h * c)
    out = torch.matmul(wx, tmp).view(b, out_w, out_h, c)  # [B, ow, oh, C]
    return out.transpose(1, 2).contiguous()


def warp_points(points_xy: torch.Tensor, params: WarpParams) -> torch.Tensor:
    """Map [B, K, 2] (x, y) source points into output coordinates with the
    imgaug keypoint convention ``x' = (x - offset_x) / scale_x`` (positive
    scales)."""
    x = (points_xy[..., 0] - params.offset[:, 1:2]) / params.scale[:, 1:2]
    y = (points_xy[..., 1] - params.offset[:, 0:1]) / params.scale[:, 0:1]
    return torch.stack([x, y], dim=-1)

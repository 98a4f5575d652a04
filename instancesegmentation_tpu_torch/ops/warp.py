"""Fused instance-crop warp: the reference's centring translate (+ rotate)
+ crop-and-pad + resize as ONE warp per sample, batched.

Port of ``instancesegmentation_tpu/ops/warp.py``.  Every function takes a
leading batch dimension; the JAX package vmaps the per-sample versions.

The separable half (``WarpParams``, ``center_translation``,
``clipped_mask_box``, ``instance_warp_params``, ``_axis_weights``,
``warp_image``, ``warp_points``, ``flip_params_x``) samples

  src = (u + 0.5) * scale - 0.5 + offset

with explicit separable bilinear weight matrices, so positions outside the
source read an implicit zero (the reference's black fill), and
``src_lo``/``src_hi`` zero the source pixels that the centring translation
cut off the canvas.  The two contractions are ``torch.matmul``s.

The rotated half (``RotWarpParams``, ``rotated_mask_box``,
``rotated_instance_warp_params``, ``warp_image_rotated`` (4-tap gather),
``warp_image_rotated_2pass``, ``warp_image_rotated_2level``,
``warp_points_rotated``, ``flip_rot_params_x``) composes translate ->
rotate-about-centre -> crop+resize.  These are plain PyTorch, as the JAX
package computes them in XLA; ``warp_image_rotated_2level`` is also the
plain version of the kernels of ``ops/warp_2level.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

#: Margin (px) jittered windows may extend beyond the canvas; bounds the
#: jitter so crops stay near the canvas (the sampler is exactly zero-fill at
#: any distance).
SRC_PAD = 24


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


def _jitter_window(wy0, wx0, wy1, wx1, jitter, h, w):
    """Multiplicative window jitter (dy0, dx0, dy1, dx1) as fractions of the
    window size, clamped to ``SRC_PAD - 4`` px around the canvas."""
    win_w = wx1 - wx0
    win_h = wy1 - wy0
    margin = SRC_PAD - 4
    wy0 = torch.clamp(wy0 + jitter[:, 0] * win_h, torch.full_like(h, -margin), h + margin)
    wx0 = torch.clamp(wx0 + jitter[:, 1] * win_w, torch.full_like(w, -margin), w + margin)
    wy1 = torch.clamp(wy1 + jitter[:, 2] * win_h, wy0 + 1.0, h + margin)
    wx1 = torch.clamp(wx1 + jitter[:, 3] * win_w, wx0 + 1.0, w + margin)
    return wy0, wx0, wy1, wx1


def instance_warp_params(obj_box, mask_box, image_hw, out_hw, pad: int = 16,
                         mask_valid=None, jitter=None) -> WarpParams:
    """The fused warp of each sample (all inputs float [B, ...]).

    obj_box [B,4] xyxy annotation box (drives the centring translation);
    mask_box [B,4] xyxy tight instance-mask box in original coordinates
    (x1/y1 exclusive); image_hw [B,2]; mask_valid [B] bool, False falls back
    to the whole image as the crop box; jitter [B,4] optional window jitter
    (dy0, dx0, dy1, dx1) as fractions of the window size.
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
    if jitter is not None:
        wy0, wx0, wy1, wx1 = _jitter_window(wy0, wx0, wy1, wx1, jitter, h, w)

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


def flip_params_x(params: WarpParams, out_w: int) -> WarpParams:
    """Mirror the warp horizontally (sample right-to-left): flipped sample u
    reads the source of ``out_w-1-u``, i.e. ``scale_x -> -scale_x`` and
    ``offset_x -> offset_x + out_w*scale_x``."""
    scale = torch.stack([params.scale[:, 0], -params.scale[:, 1]], dim=1)
    offset = torch.stack([params.offset[:, 0],
                          params.offset[:, 1] + out_w * params.scale[:, 1]], dim=1)
    return WarpParams(scale, offset, params.src_lo, params.src_hi)


# -- rotation ----------------------------------------------------------------
# The chain becomes translate -> rotate-about-centre -> mask-box crop+resize.
# Rotation is not separable: ``warp_image_rotated`` samples with a 4-tap
# bilinear gather, ``warp_image_rotated_2pass`` and ``_2level`` with the
# two-pass (horizontal, then vertical) decomposition of the affine map.


class RotWarpParams(NamedTuple):
    """Per-sample fused translate-rotate-crop-resize mapping, fields [B, 2]
    ordered (y, x) except ``cos_sin`` = (cos, sin).

    Output pixel (u, v) -> rotated-frame position
    ``p_rot = (uv + 0.5) * scale - 0.5 + origin``; positions outside the
    canvas ``canvas_hw`` read black (the rotation cut).  Source position
    ``src = center + R(-theta) @ (p_rot - center) - t``; source pixels outside
    ``[src_lo, src_hi)`` read black (the translation cut).
    """

    scale: torch.Tensor
    origin: torch.Tensor
    cos_sin: torch.Tensor
    center: torch.Tensor
    t: torch.Tensor        # (ty, tx) centring translation
    src_lo: torch.Tensor
    src_hi: torch.Tensor
    canvas_hw: torch.Tensor

    def index(self, sl) -> "RotWarpParams":
        """The params of the samples ``sl`` (a slice or index tensor)."""
        return RotWarpParams(*(f[sl] for f in self))


def rotated_mask_box(mask: torch.Tensor, ty_tx, theta: torch.Tensor,
                     image_hw: torch.Tensor):
    """Box (rotated-frame coords, x1/y1 exclusive) of the mask pixels that
    survive translate -> rotate-about-centre, and a validity flag.

    mask [B, H, W], ty_tx ([B], [B]), theta [B] radians, image_hw [B, 2] ->
    (boxes [B, 4] xyxy float32, valid [B] bool).  The geometric box of the
    surviving pixel centres, floored.
    """
    ty, tx = (t.view(-1, 1, 1) for t in ty_tx)
    h = image_hw[:, 0].view(-1, 1, 1)
    w = image_hw[:, 1].view(-1, 1, 1)
    ch, cw = mask.shape[1], mask.shape[2]
    dev = mask.device
    ys = torch.arange(ch, dtype=torch.float32, device=dev).view(1, -1, 1)
    xs = torch.arange(cw, dtype=torch.float32, device=dev).view(1, 1, -1)
    xt = xs + tx
    yt = ys + ty
    on = (mask > 0) & (xt >= 0) & (xt < w) & (yt >= 0) & (yt < h)
    c = torch.cos(theta).view(-1, 1, 1)
    s = torch.sin(theta).view(-1, 1, 1)
    cx = w / 2.0 - 0.5
    cy = h / 2.0 - 0.5
    xr = cx + c * (xt - cx) - s * (yt - cy)
    yr = cy + s * (xt - cx) + c * (yt - cy)
    on = on & (xr >= 0) & (xr < w) & (yr >= 0) & (yr < h)
    valid = on.flatten(1).any(dim=1)
    big = torch.tensor(float(max(ch, cw)) * 2.0, device=dev)
    x0 = torch.floor(torch.where(on, xr, big).flatten(1).amin(dim=1))
    y0 = torch.floor(torch.where(on, yr, big).flatten(1).amin(dim=1))
    x1 = torch.floor(torch.where(on, xr, -big).flatten(1).amax(dim=1)) + 1.0
    y1 = torch.floor(torch.where(on, yr, -big).flatten(1).amax(dim=1)) + 1.0
    return torch.stack([x0, y0, x1, y1], dim=1), valid


def rotated_instance_warp_params(obj_box, rot_box, image_hw, theta, out_hw,
                                 pad: int = 16, box_valid=None,
                                 jitter=None) -> RotWarpParams:
    """The ``RotWarpParams`` of each sample: the rotated analogue of
    ``instance_warp_params``.  ``rot_box`` [B,4] is the rotated-frame crop box
    from ``rotated_mask_box``; invalid boxes fall back to the whole canvas."""
    h, w = image_hw[:, 0], image_hw[:, 1]
    ty, tx = center_translation(obj_box, image_hw)
    zero = torch.zeros_like(w)
    whole = torch.stack([zero, zero, w, h], dim=1)
    rb = rot_box if box_valid is None else torch.where(box_valid[:, None], rot_box, whole)
    wx0, wy0 = rb[:, 0] - pad, rb[:, 1] - pad
    wx1, wy1 = rb[:, 2] + pad, rb[:, 3] + pad
    if jitter is not None:
        wy0, wx0, wy1, wx1 = _jitter_window(wy0, wx0, wy1, wx1, jitter, h, w)
    out_h, out_w = out_hw
    return RotWarpParams(
        scale=torch.stack([(wy1 - wy0) / out_h, (wx1 - wx0) / out_w], dim=1),
        origin=torch.stack([wy0, wx0], dim=1),
        cos_sin=torch.stack([torch.cos(theta), torch.sin(theta)], dim=1),
        center=torch.stack([h / 2.0 - 0.5, w / 2.0 - 0.5], dim=1),
        t=torch.stack([ty, tx], dim=1),
        src_lo=torch.stack([torch.clamp_min(-ty, 0.0), torch.clamp_min(-tx, 0.0)], dim=1),
        src_hi=torch.stack([torch.minimum(h, h - ty), torch.minimum(w, w - tx)], dim=1),
        canvas_hw=torch.stack([h, w], dim=1),
    )


def warp_image_rotated(image: torch.Tensor, params: RotWarpParams, out_hw) -> torch.Tensor:
    """Sample float images [B, H, W, C] through ``params`` to
    [B, out_h, out_w, C] float32: a 4-tap bilinear gather with black fill at
    the canvas edge, the rotation cut and the translation cut per tap."""
    out_h, out_w = out_hw
    b, h, w, c = image.shape
    dev = image.device

    def col(i, f):  # [B] field -> [B, 1, 1]
        return f[:, i].view(-1, 1, 1)

    u = torch.arange(out_h, dtype=torch.float32, device=dev).view(1, -1, 1)
    v = torch.arange(out_w, dtype=torch.float32, device=dev).view(1, 1, -1)
    py = (u + 0.5) * col(0, params.scale) - 0.5 + col(0, params.origin)
    px = (v + 0.5) * col(1, params.scale) - 0.5 + col(1, params.origin)
    rot_ok = ((py >= 0) & (py < col(0, params.canvas_hw))
              & (px >= 0) & (px < col(1, params.canvas_hw)))
    cth, sth = col(0, params.cos_sin), col(1, params.cos_sin)
    cy, cx = col(0, params.center), col(1, params.center)
    dy = py - cy
    dx = px - cx
    # inverse rotation R(-theta) back into the translated frame
    sy = cy + (-sth) * dx + cth * dy - col(0, params.t)
    sx = cx + cth * dx + sth * dy - col(1, params.t)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    flat = image.reshape(b, h * w, c).float()

    def tap(yi, xi, wgt):
        ok = (rot_ok
              & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
              & (yi >= col(0, params.src_lo)) & (yi < col(0, params.src_hi))
              & (xi >= col(1, params.src_lo)) & (xi < col(1, params.src_hi)))
        idx = (yi.clamp(0, h - 1).to(torch.int64) * w
               + xi.clamp(0, w - 1).to(torch.int64))
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(b, out_h * out_w, c))
        return vals.view(b, out_h, out_w, c) * (wgt * ok.float())[..., None]

    return (tap(y0, x0, (1 - fy) * (1 - fx))
            + tap(y0, x0 + 1, (1 - fy) * fx)
            + tap(y0 + 1, x0, fy * (1 - fx))
            + tap(y0 + 1, x0 + 1, fy * fx))


def _affine_terms(params: RotWarpParams) -> dict:
    """The two-pass decomposition of the inverse affine map, per sample [B]:
    ``[sy; sx] = M [u; v] + k`` with pass 1 (horizontal, at integer canvas
    rows y) ``X(y, v) = Ax*v + Bx*y + Cx`` and pass 2 (vertical)
    ``Y(u, v) = m00*u + m01*v + ky0``.  The operation order is the JAX
    package's, so positions round alike."""
    cth, sth = params.cos_sin[:, 0], params.cos_sin[:, 1]
    a_y, a_x = params.scale[:, 0], params.scale[:, 1]
    b_y = 0.5 * a_y - 0.5 + params.origin[:, 0]
    b_x = 0.5 * a_x - 0.5 + params.origin[:, 1]
    cy, cx = params.center[:, 0], params.center[:, 1]
    m00, m01 = cth * a_y, -sth * a_x
    m10, m11 = sth * a_y, cth * a_x
    ky0 = cy + cth * (b_y - cy) - sth * (b_x - cx) - params.t[:, 0]
    kx0 = cx + sth * (b_y - cy) + cth * (b_x - cx) - params.t[:, 1]
    return dict(a_y=a_y, a_x=a_x, b_y=b_y, b_x=b_x, m00=m00, m01=m01, m10=m10,
                m11=m11, ky0=ky0, kx0=kx0, Ax=m11 - m10 * m01 / m00,
                Bx=m10 / m00, Cx=kx0 - m10 * ky0 / m00)


def _rotation_cut(k: dict, params: RotWarpParams, out_hw, dev) -> torch.Tensor:
    """[B, out_h, out_w, 1] float mask of output pixels whose rotated-frame
    position lies on the canvas (exactly separable: py depends on u only,
    px on v only)."""
    out_h, out_w = out_hw
    pyu = k["a_y"][:, None] * torch.arange(out_h, dtype=torch.float32, device=dev) + k["b_y"][:, None]
    pxv = k["a_x"][:, None] * torch.arange(out_w, dtype=torch.float32, device=dev) + k["b_x"][:, None]
    row_ok = (pyu >= 0) & (pyu < params.canvas_hw[:, 0:1])
    col_ok = (pxv >= 0) & (pxv < params.canvas_hw[:, 1:2])
    return (row_ok[:, :, None] & col_ok[:, None, :]).float()[..., None]


def warp_image_rotated_2pass(image: torch.Tensor, params: RotWarpParams, out_hw) -> torch.Tensor:
    """Two-pass (Catmull-Smith) form of ``warp_image_rotated``: a horizontal
    then a vertical 1-D bilinear resample, each a banded one-hot contraction
    (``einsum``), with per-tap cut masks and the separable rotation cut.

    Valid for |theta| well below 90 deg (pass 1 divides by cos(theta)); the
    pipeline falls back to the gather sampler at 60 deg or more.  The
    per-sample hats are [h, out_w, w] and [out_w, out_h, h] float32 (786 MB
    at 640 -> 480), so batch callers stage it (``AugmentConfig.rotate_chunk``).
    """
    out_h, out_w = out_hw
    b, h, w, _ = image.shape
    dev = image.device
    f32 = torch.float32
    k = _affine_terms(params)

    def hat(pos, n_in, lo, hi):
        """[..., n_in] bilinear hat rows at ``pos`` [B, ...] with tap validity
        [max(0, lo), min(n_in, hi)) per sample."""
        taps = torch.arange(n_in, dtype=f32, device=dev)
        wgt = torch.clamp_min(1.0 - torch.abs(pos[..., None] - taps), 0.0)
        shape = (-1,) + (1,) * pos.dim()
        ok = ((taps >= torch.clamp_min(lo, 0.0).view(shape))
              & (taps < torch.clamp_max(hi, float(n_in)).view(shape)))
        return wgt * ok.to(f32)

    yi = torch.arange(h, dtype=f32, device=dev).view(1, -1, 1)
    vi = torch.arange(out_w, dtype=f32, device=dev).view(1, 1, -1)

    def per(name):
        return k[name].view(-1, 1, 1)

    xpos = ((per("m11") - per("m10") * per("m01") / per("m00")) * vi
            + (per("m10") / per("m00")) * yi
            + (per("kx0") - per("m10") * per("ky0") / per("m00")))       # [B, h, v]
    k1 = hat(xpos, w, params.src_lo[:, 1], params.src_hi[:, 1])          # [B, h, v, w]
    tmp = torch.einsum("bywc,byvw->byvc", image.float(), k1)            # [B, h, v, c]

    ui = torch.arange(out_h, dtype=f32, device=dev).view(1, -1, 1)
    ypos = per("m00") * ui + per("m01") * vi + per("ky0")                # [B, u, v]
    k2 = hat(ypos.transpose(1, 2), h, params.src_lo[:, 0], params.src_hi[:, 0])  # [B, v, u, y]
    out = torch.einsum("bvyc,bvuy->buvc", tmp.transpose(1, 2), k2)
    return out * _rotation_cut(k, params, out_hw, dev)


def two_level_bands(theta_max_deg: float, block: int, scale_x_max: float):
    """The static residual bands ``(D1, D2)`` of the two-level sampler, or
    ``ValueError`` when ``theta_max_deg`` (DEGREES) is outside (0, 60)."""
    t_max_deg = abs(float(theta_max_deg))
    if not 0.0 < t_max_deg < 60.0:
        raise ValueError(
            "theta_max_deg is in DEGREES and must lie in (0, 60): got "
            f"{theta_max_deg!r} (the two-pass decomposition divides by "
            "cos(theta); use the gather sampler beyond 60 deg)")
    t_max = t_max_deg * math.pi / 180.0
    d1 = max(1, int(math.ceil(math.tan(t_max) * (block - 1) / 2.0)))
    d2 = max(1, int(math.ceil(math.sin(t_max) * float(scale_x_max) * (block - 1) / 2.0)))
    return d1, d2


def _content_cut(image: torch.Tensor, params: RotWarpParams) -> torch.Tensor:
    """``image`` [B, h, w, C] as float32 with the translation cut applied to
    the content: source pixels outside ``[src_lo, src_hi)`` zeroed."""
    _, h, w, _ = image.shape
    dev = image.device
    col = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, -1, 1)
    row = torch.arange(h, dtype=torch.float32, device=dev).view(1, -1, 1, 1)
    lo = params.src_lo.view(-1, 1, 1, 2)
    hi = params.src_hi.view(-1, 1, 1, 2)
    mx = (col >= torch.clamp_min(lo[..., 1:], 0.0)) & (col < torch.clamp_max(hi[..., 1:], float(w)))
    my = (row >= torch.clamp_min(lo[..., :1], 0.0)) & (row < torch.clamp_max(hi[..., :1], float(h)))
    return image.float() * (mx & my).float()


def _residual_shift(x: torch.Tensor, delta: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """Lerp-shift ``x`` [B, n, m, C] along ``dim`` (2: columns, one delta per
    row; 1: rows, one delta per column) by the bounded fractional offsets
    ``delta`` [B, len]: ``sum_k hat(delta - k) * shift_k(x)`` over
    k = -d..d, with black fill.  Deltas outside [-d, d] clip to the band
    edge."""
    offs = torch.arange(-d, d + 1, dtype=torch.float32, device=x.device)
    wgt = torch.clamp_min(
        1.0 - torch.abs(torch.clamp(delta, -float(d), float(d))[..., None] - offs), 0.0)
    n = x.shape[dim]
    pad = [0, 0, d, d] if dim == 2 else [0, 0, 0, 0, d, d]
    padded = torch.nn.functional.pad(x, pad)
    acc = torch.zeros_like(x)
    for j in range(2 * d + 1):
        sl = padded.narrow(dim, j, n)
        w = wgt[..., j]
        acc = acc + sl * (w[:, :, None, None] if dim == 2 else w[:, None, :, None])
    return acc


def warp_image_rotated_2level(image: torch.Tensor, params: RotWarpParams, out_hw,
                              theta_max_deg: float, scale_x_max: Optional[float] = None,
                              block: int = 16) -> torch.Tensor:
    """Two-level form of ``warp_image_rotated_2pass``: each pass's hats are
    made once per block of ``block`` rows (columns for pass 2), and the
    per-row residual offset is applied as a bounded fractional lerp shift.

    Within a row block, pass-1 positions differ only by ``tan(theta)*(r-rc)``
    source columns, so the band is ``D1 = ceil(tan(theta_max)*(block-1)/2)``;
    pass 2's residual is ``-sin(theta)*scale_x*(r-rc)`` source rows, bounded
    through ``scale_x_max`` (default ``(w + 2*SRC_PAD)/out_w``).  Residuals of
    out-of-contract samples (|theta| > theta_max_deg) clip to the band edge.
    theta = 0 reduces to the separable sample.  The translation cut is
    applied to the content first (``_content_cut``), which keeps the residual
    shifts from leaking cut content.  ``theta_max_deg`` is in DEGREES and
    must lie in (0, 60).

    This is the plain version of the kernels of ``ops/warp_2level.py``; it
    materialises the per-block hats ([B, h/block, out_w, w] and
    [B, out_w/block, out_h, h] float32).
    """
    out_h, out_w = out_hw
    b, h, w, c = image.shape
    dev = image.device
    f32 = torch.float32
    g = block
    if scale_x_max is None:
        scale_x_max = (w + 2 * SRC_PAD) / out_w
    d1, d2 = two_level_bands(theta_max_deg, g, scale_x_max)
    k = _affine_terms(params)
    img = _content_cut(image, params)
    rc = (g - 1) / 2.0

    def hat_plain(pos, n_in):
        taps = torch.arange(n_in, dtype=f32, device=dev)
        return torch.clamp_min(1.0 - torch.abs(pos[..., None] - taps), 0.0)

    # pass 1 (horizontal): X(y, v) = Ax*v + Bx*y + Cx
    hp = -h % g
    if hp:
        img = torch.nn.functional.pad(img, (0, 0, 0, 0, 0, hp))
    n_g1 = (h + hp) // g
    r1 = (torch.arange(g, dtype=f32, device=dev) - rc).repeat(n_g1)
    img_a = _residual_shift(img, k["Bx"][:, None] * r1, d1, dim=2)
    ycent = torch.arange(n_g1, dtype=f32, device=dev) * g + rc
    vv = torch.arange(out_w, dtype=f32, device=dev)
    vpos = (k["Ax"].view(-1, 1, 1) * vv + k["Bx"].view(-1, 1, 1) * ycent[:, None]
            + k["Cx"].view(-1, 1, 1))                                   # [B, nG1, v]
    k1 = hat_plain(vpos, w)                                             # [B, nG1, v, w]
    tmp = torch.einsum("bgrwc,bgvw->bgrvc", img_a.view(b, n_g1, g, w, c), k1)
    tmp = tmp.reshape(b, h + hp, out_w, c)[:, :h]                       # [B, h, v, c]

    # pass 2 (vertical): Y(u, v) = m00*u + m01*v + ky0
    vp = -out_w % g
    if vp:
        tmp = torch.nn.functional.pad(tmp, (0, 0, 0, vp))
    n_g2 = (out_w + vp) // g
    r2 = (torch.arange(g, dtype=f32, device=dev) - rc).repeat(n_g2)
    tmp_a = _residual_shift(tmp, k["m01"][:, None] * r2, d2, dim=1)
    vcent = torch.arange(n_g2, dtype=f32, device=dev) * g + rc
    uu = torch.arange(out_h, dtype=f32, device=dev)
    upos = (k["m00"].view(-1, 1, 1) * uu + k["m01"].view(-1, 1, 1) * vcent[:, None]
            + k["ky0"].view(-1, 1, 1))                                  # [B, nG2, u]
    k2 = hat_plain(upos, h)                                             # [B, nG2, u, y]
    out = torch.einsum("bygrc,bguy->bugrc", tmp_a.view(b, h, n_g2, g, c), k2)
    out = out.reshape(b, out_h, out_w + vp, c)[:, :, :out_w]
    return out * _rotation_cut(k, params, out_hw, dev)


def warp_points_rotated(points_xy: torch.Tensor, params: RotWarpParams) -> torch.Tensor:
    """Map [B, K, 2] (x, y) source points through translate -> rotate ->
    window into output coordinates (imgaug ratio convention, as
    ``warp_points``)."""
    c, s = params.cos_sin[:, 0:1], params.cos_sin[:, 1:2]
    cy, cx = params.center[:, 0:1], params.center[:, 1:2]
    xt = points_xy[..., 0] + params.t[:, 1:2]
    yt = points_xy[..., 1] + params.t[:, 0:1]
    xr = cx + c * (xt - cx) - s * (yt - cy)
    yr = cy + s * (xt - cx) + c * (yt - cy)
    x = (xr - params.origin[:, 1:2]) / params.scale[:, 1:2]
    y = (yr - params.origin[:, 0:1]) / params.scale[:, 0:1]
    return torch.stack([x, y], dim=-1)


def flip_rot_params_x(params: RotWarpParams, out_w: int) -> RotWarpParams:
    """Mirror a rotated warp horizontally (the identity of
    ``flip_params_x``: p_rot is affine in the output column)."""
    return params._replace(
        scale=torch.stack([params.scale[:, 0], -params.scale[:, 1]], dim=1),
        origin=torch.stack([params.origin[:, 0],
                            params.origin[:, 1] + out_w * params.scale[:, 1]], dim=1),
    )

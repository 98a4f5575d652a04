"""Fold the 17-channel heatmap conditioning through the stem as
per-keypoint patch convs: no full-resolution heatmap stack.

Port of ``instancesegmentation_tpu/models/fused_stem_hm.py``.  The
conditioned model feeds ``concat(RGB, 17 heatmaps)`` to ``InitHeadS4``.
Every Gaussian lives inside a window of at most 44 pixels around its
keypoint (sigma 10, threshold 0.01), and the stem touches the heatmap
channels in two ways that fold to patch-local work:

1. ``conv1`` (k5 s2 p2) is linear, so ``conv1(concat(img, hm)) =
   conv1_img(img) + sum_k conv1_k(hm_k)``.  Each ``hm_k`` is supported on
   one 48 x 48 patch, so its term is a VALID conv of the zero-padded patch
   with that keypoint's kernel slice (one grouped conv, ``groups=17``),
   added into the ``conv1_img`` output at the patch's stride-aligned
   offset;
2. the maxpool4 shortcut of ``hm_k`` (``hm >= 0``) is zero outside the
   pooled patch, so it is the pooled patch placed into a zero plane.

BN running statistics fold into the kernels and biases (inference only,
as ``models/fused_stem.fold_stem``).  The patches are windows of the dense
render's own separable factors (``ops/heatmap.py:separable_factors``), so
the implied dense stack equals ``render_heatmaps`` bit for bit, on the CPU
and on the card; only conv reduction order differs from the unfused stem.

Placement: the conv deltas ``[N, K, OP, OP, 16]`` (``OP = P/2 + 2``) are
added into a +1-shifted ``[N, H/2+2, W/2+2, 16]`` plane one keypoint at a
time, ``k = 0..16`` (the order of JAX's ``"dus"`` oracle, so the sum is
deterministic).  Within one ``k`` no two samples share a plane, so each
step is a gather, an add and a scatter of distinct elements, no atomics.
The pooled planes land on disjoint channels, so their placement is exact.

Patch geometry: the window's width is at most ``trunc(x+r+1) - trunc(x-r)
<= 44`` px; the origin ``x0 = 4 * (x_min // 4)``, clamped to ``[0, w - P]``,
loses at most 3 px to the alignment, so ``P = 48`` covers every window and
keeps maxpool cells whole; the conv taps reach 4 px past the patch, so the
patch is zero-padded by 4 and the VALID s2 conv gives ``P/2 + 2`` outputs
at global offset ``x0/2 - 1``.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from instancesegmentation_tpu_torch.models.fused_stem import _fold_layer, nchw, prelu_nhwc
from instancesegmentation_tpu_torch.ops.heatmap import separable_factors

#: the heatmap encoder's constants (ops/heatmap.render_heatmaps defaults)
SIGMA = 10.0
THRESHOLD = 0.01
#: the patch side: the <= 44 px window plus <= 3 px of mod-4 alignment
PATCH = 48


class FoldedStemHM(NamedTuple):
    """BN-folded stem kernels with conv1 split into image and heatmaps."""

    k1_img: torch.Tensor  # [16, 3, 5, 5] conv1's RGB slice
    k1_hm: torch.Tensor   # [17*16, 1, 5, 5] conv1's heatmap slices, groups=17
    b1: torch.Tensor      # [16]
    a1: torch.Tensor      # [16] PReLU weight
    k2: torch.Tensor      # [16, 16, 5, 5]
    b2: torch.Tensor      # [16]
    a2: torch.Tensor      # [16]

    def to(self, device) -> "FoldedStemHM":
        return FoldedStemHM(*(t.to(device) for t in self))


def fold_stem_hm(state_dict: Mapping[str, torch.Tensor],
                 name: str = "init_conv") -> FoldedStemHM:
    """The patch-folded stem of a conditioned (20-channel) Segment state
    dict, on the CPU (``FoldedStemHM.to`` moves it)."""
    k1, b1 = _fold_layer(state_dict, f"{name}.layer1")
    k2, b2 = _fold_layer(state_dict, f"{name}.layer2")
    co, ci, kh, kw = k1.shape
    if ci != 20:
        raise ValueError(f"the conditioned stem expects 20 input channels, got {ci}")
    return FoldedStemHM(
        k1_img=k1[:, :3].contiguous(),
        # grouped layout: output channel g*16 + c applies heatmap g to channel c
        k1_hm=k1[:, 3:].transpose(0, 1).reshape(17 * co, 1, kh, kw).contiguous(),
        b1=b1,
        a1=state_dict[f"{name}.layer1.act.weight"].detach().float().cpu(),
        k2=k2, b2=b2,
        a2=state_dict[f"{name}.layer2.act.weight"].detach().float().cpu(),
    )


def render_heatmap_patches(points_xy: torch.Tensor, visible: torch.Tensor, out_hw,
                           patch: int = PATCH, sigma: float = SIGMA,
                           threshold: float = THRESHOLD):
    """Each keypoint's heatmap window on a ``P x P`` patch.

    points_xy [N, K, 2], visible [N, K] -> ``(patches [N, P, P, K] float32,
    x0 [N, K] int64, y0 [N, K] int64)``, patch ``(py, px)`` of keypoint k
    holding the dense render's value at pixel ``(y0 + py, x0 + px)``.  ``P =
    min(patch, h, w)``.  The values are the dense render's own separable
    factors gathered at the patch and multiplied, so the patches equal
    ``render_heatmaps`` bit for bit; the window is its window (``trunc``,
    ``x < x_max``, ``e > threshold``).  A non-finite coordinate is set to 0
    only for the origin; its window is empty, as in the dense render.
    """
    h, w = out_hw
    p = min(patch, h, w)
    if p % 4:
        raise ValueError(f"patch {p} must be a multiple of 4 (maxpool4 cells)")
    r = math.sqrt(-math.log(threshold) * sigma * sigma)
    ex, ey = separable_factors(points_xy, visible, out_hw, sigma, threshold)

    pts = points_xy.float()
    pts = torch.where(torch.isfinite(pts), pts, 0.0)
    x_min = torch.clamp_min(torch.trunc(pts[..., 0] - r), 0.0).long()
    y_min = torch.clamp_min(torch.trunc(pts[..., 1] - r), 0.0).long()
    x0 = torch.clamp((x_min // 4) * 4, 0, w - p)  # [N, K]
    y0 = torch.clamp((y_min // 4) * 4, 0, h - p)

    grid = torch.arange(p, device=points_xy.device)
    cols = (x0[:, None, :] + grid[None, :, None])[:, None]   # [N, 1, P, K]
    rows = (y0[:, None, :] + grid[None, :, None])[:, :, None]  # [N, P, 1, K]
    e = ex.gather(2, cols) * ey.gather(1, rows)               # [N, P, P, K]
    return torch.where(e > threshold, e, 0.0), x0, y0


def _conv5x5(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """k5 s2 p2 conv of NHWC ``x`` -> NHWC."""
    return F.conv2d(nchw(x), kernel.to(x.dtype), stride=2, padding=2).permute(0, 2, 3, 1)


def _accumulate_conv_patches(deltas: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                             out_hw) -> torch.Tensor:
    """Sum per-keypoint conv outputs into a +1-shifted ``[H/2+2, W/2+2]``
    plane, ``k = 0..K-1`` in turn, in ``deltas``' dtype.

    deltas [N, K, OP, OP, C], offsets [N, K] in input pixels.  Returns
    [N, H/2, W/2, C]."""
    n, k, op, _, co = deltas.shape
    h2, w2 = out_hw[0] // 2, out_hw[1] // 2
    buf = deltas.new_zeros((n, h2 + 2, w2 + 2, co))
    grid = torch.arange(op, device=deltas.device)
    samples = torch.arange(n, device=deltas.device)[:, None, None]
    for i in range(k):
        # the +1 shift: patch row 0 lands on global row y0/2 - 1
        rows = (y0[:, i] // 2)[:, None, None] + grid[None, :, None]
        cols = (x0[:, i] // 2)[:, None, None] + grid[None, None, :]
        buf[samples, rows, cols] = buf[samples, rows, cols] + deltas[:, i]
    return buf[:, 1:h2 + 1, 1:w2 + 1]


def _pooled_hm_planes(patches: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                      out_hw) -> torch.Tensor:
    """maxpool4 of the implied dense heatmap stack from the pooled patches.

    patches [N, P, P, K] (in the compute dtype), offsets [N, K] (multiples
    of 4).  Returns [N, H/4, W/4, K]."""
    n, p, _, k = patches.shape
    h4, w4 = out_hw[0] // 4, out_hw[1] // 4
    pooled = F.max_pool2d(patches.permute(0, 3, 1, 2), 4, 4)  # [N, K, P4, P4]
    p4 = p // 4
    grid = torch.arange(p4, device=patches.device)
    samples = torch.arange(n, device=patches.device)[:, None, None, None]
    chans = torch.arange(k, device=patches.device)[None, :, None, None]
    rows = (y0 // 4)[:, :, None, None] + grid[None, None, :, None]
    cols = (x0 // 4)[:, :, None, None] + grid[None, None, None, :]
    planes = patches.new_zeros((n, h4, w4, k))
    planes[samples, rows, cols, chans] = pooled
    return planes


def stem_hm_apply(images: torch.Tensor, points_xy: torch.Tensor, visible: torch.Tensor,
                  stem: FoldedStemHM, dtype=torch.bfloat16) -> torch.Tensor:
    """The folded conditioned stem: normalised RGB and keypoints ->
    ``InitHeadS4``'s output [N, H/4, W/4, 36] NHWC, with no [H, W, 17]
    heatmap stack.

    images [N, H, W, 3] normalised; points_xy [N, 17, 2] in output-image
    coordinates; visible [N, 17] bool.  Channels as ``InitHeadS4``: pooled
    RGB (3), pooled heatmaps (17), conv features (16).  Feed the result to
    ``Segment(..., skip_stem=True)``.
    """
    n, h, w, _ = images.shape
    out_hw = (h, w)
    xd = images.to(dtype)
    patches, x0, y0 = render_heatmap_patches(points_xy, visible, out_hw)
    patches = patches.to(dtype)  # the dense path's cast point
    k = patches.shape[-1]
    op = patches.shape[1] // 2 + 2

    # conv1: the RGB conv plus the per-keypoint patch convs, placed and summed
    conv_img = _conv5x5(xd, stem.k1_img)
    padded = F.pad(patches.permute(0, 3, 1, 2), (4, 4, 4, 4))
    grouped = F.conv2d(padded, stem.k1_hm.to(dtype), stride=2, groups=k)  # [N, 17*16, OP, OP]
    deltas = grouped.reshape(n, k, -1, op, op).permute(0, 1, 3, 4, 2)    # [N, K, OP, OP, 16]
    conv1 = conv_img + _accumulate_conv_patches(deltas, x0, y0, out_hw)
    y = prelu_nhwc(conv1 + stem.b1.to(dtype), stem.a1)

    # conv2, dense 16 -> 16
    y = prelu_nhwc(_conv5x5(y, stem.k2) + stem.b2.to(dtype), stem.a2)

    # the maxpool4 shortcut: RGB pooled densely, heatmaps from the patches
    short_img = F.max_pool2d(nchw(xd), 4, 4).permute(0, 2, 3, 1)
    short_hm = _pooled_hm_planes(patches, x0, y0, out_hw)
    return torch.cat([short_img, short_hm, y], dim=-1)

"""Keypoint -> Gaussian heatmap rendering, batched, on the device.

Port of ``instancesegmentation_tpu/ops/heatmap.py:render_heatmaps``.  For
each visible keypoint at (x, y):

  r      = sqrt(-ln(threshold) * sigma^2)
  window = [max(0, trunc(x-r)), min(w-1, trunc(x+r+1)))   (same for y)
  e      = exp(-(X-x)^2 / sigma^2) * exp(-(Y-y)^2 / sigma^2)
  hm     = e where (inside window) & (e > threshold), else 0

Quirks kept: the window's upper bound clamps to ``w-1`` / ``h-1`` (the last
row and column are never rendered) and the bounds truncate toward zero like
Python ``int()``.  The Gaussian is separable, so the exponentials are taken
on [W,K] and [H,K] vectors and the stack is one broadcast product.
"""
from __future__ import annotations

import math

import torch


def separable_factors(points_xy: torch.Tensor, visible: torch.Tensor, out_hw,
                      sigma: float = 10.0, threshold: float = 0.01):
    """The two factors of ``render_heatmaps``'s product: ``ex [B, 1, W, K]``
    (the window's columns and the visibility applied) and ``ey [B, H, 1, K]``
    (its rows), zero outside the window."""
    h, w = out_hw
    r = math.sqrt(-math.log(threshold) * sigma * sigma)
    dev = points_xy.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w, 1)
    pts = points_xy.float()
    x = pts[..., 0][:, None, None, :]  # [B, 1, 1, K]
    y = pts[..., 1][:, None, None, :]

    x_min = torch.clamp_min(torch.trunc(x - r), 0.0)
    x_max = torch.clamp_max(torch.trunc(x + r + 1.0), float(w - 1))
    y_min = torch.clamp_min(torch.trunc(y - r), 0.0)
    y_max = torch.clamp_max(torch.trunc(y + r + 1.0), float(h - 1))
    inv = 1.0 / (sigma * sigma)
    # the window and visibility masks ride the separable factors: outside
    # them the product is 0, which the threshold test also maps to 0
    ex = torch.where((xs >= x_min) & (xs < x_max) & visible[:, None, None, :],
                     torch.exp(-((xs - x) ** 2) * inv), 0.0)  # [B, 1, W, K]
    ey = torch.where((ys >= y_min) & (ys < y_max),
                     torch.exp(-((ys - y) ** 2) * inv), 0.0)  # [B, H, 1, K]
    return ex, ey


def render_heatmaps(points_xy: torch.Tensor, visible: torch.Tensor, out_hw,
                    sigma: float = 10.0, threshold: float = 0.01) -> torch.Tensor:
    """Render [B, K] keypoints to a [B, H, W, K] float32 heatmap stack.

    points_xy: [B, K, 2] (x, y) in output-image coordinates.
    visible:   [B, K] bool, True only for visible keypoints.
    """
    ex, ey = separable_factors(points_xy, visible, out_hw, sigma, threshold)
    e = ex * ey
    return torch.where(e > threshold, e, 0.0)

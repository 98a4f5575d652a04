"""RoI-Align with torchvision semantics on NHWC features.

Port of ``instancesegmentation_tpu/ops/roi_align.py`` (``roi_align`` and the
Pallas kernel ``roi_align_pallas``).  Every output bin is the mean of
``sampling_ratio**2`` bilinear samples; ``aligned=True`` applies the -0.5
half-pixel offset, ``aligned=False`` clamps the ROI size to at least 1; a
sample centre outside ``[-1, size]`` contributes zero and one inside is
clamped to ``[0, size - 1]``.  The adaptive ratio (``sampling_ratio <= 0``
in torchvision) is not supported, as in the JAX function.

A CPU tensor runs ``roi_align_reference``, the JAX package's separable form
``Wy . feat . Wx^T`` per ROI, over chunks of ROIs so that the gathered
feature maps stay small.  A CUDA tensor runs the kernel of
``csrc/roi_align.cu``, which samples the NHWC map directly (counted in
``roi_align.launches``).
"""
from __future__ import annotations

import ctypes

import torch

#: ROIs per chunk of the plain version: it gathers one whole feature map per
#: ROI, 69 MB at [200, 336, 256] in float32
REFERENCE_CHUNK = 16


def _full(like: torch.Tensor, value) -> torch.Tensor:
    """A float32 divisor tensor: a CUDA division by a Python scalar multiplies
    by its reciprocal, one rounding away from the true quotient that JAX and
    the kernel take."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def _interp_weights(starts, bin_size, size: int, out_dim: int, ratio: int):
    """Averaged bilinear weights of one axis: ``[R, out_dim, size]``.

    ``starts`` and ``bin_size`` are ``[R]``: the ROI's offset start and bin
    size on this axis.
    """
    dev = starts.device
    o = torch.arange(out_dim, dtype=torch.float32, device=dev)[:, None]
    s = (torch.arange(ratio, dtype=torch.float32, device=dev) + 0.5) / _full(starts, ratio)
    centers = starts[:, None, None] + (o + s[None, :]) * bin_size[:, None, None]
    valid = (centers >= -1.0) & (centers <= float(size))
    cc = centers.clamp(0.0, float(size) - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w = (1.0 - (cc[..., None] - grid).abs()).clamp(min=0.0)  # the bilinear hat
    w = torch.where(valid[..., None], w, torch.zeros((), device=dev))
    return w.mean(dim=2)


def _roi_geometry(boxes, output_size, spatial_scale: float, aligned: bool):
    """(x0, y0, bin_w, bin_h), each [R] float32."""
    oh, ow = output_size
    b = boxes.float() * spatial_scale - (0.5 if aligned else 0.0)
    x0, y0, x1, y1 = b.unbind(1)
    roi_w, roi_h = x1 - x0, y1 - y0
    if not aligned:  # legacy: ROI size at least 1
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    return x0, y0, roi_w / _full(roi_w, ow), roi_h / _full(roi_h, oh)


def roi_align_reference(features, boxes, box_indices, output_size=(7, 7),
                        spatial_scale: float = 1.0, sampling_ratio: int = 2,
                        aligned: bool = True, chunk: int = REFERENCE_CHUNK):
    """The plain version: ``features [N,H,W,C]``, ``boxes [R,4]`` xyxy in
    input coordinates, ``box_indices [R]`` -> ``[R, oh, ow, C]`` float32."""
    _, h, w, c = features.shape
    oh, ow = output_size
    x0, y0, bin_w, bin_h = _roi_geometry(boxes, output_size, spatial_scale, aligned)
    idx = box_indices.long()
    outs = [features.new_zeros((0, oh, ow, c), dtype=torch.float32)]
    for s in range(0, boxes.shape[0], chunk):
        sl = slice(s, s + chunk)
        wy = _interp_weights(y0[sl], bin_h[sl], h, oh, sampling_ratio)  # [r, oh, H]
        wx = _interp_weights(x0[sl], bin_w[sl], w, ow, sampling_ratio)  # [r, ow, W]
        feats = features[idx[sl]].float()                               # [r, H, W, C]
        tmp = torch.einsum("ryh,rhwc->rywc", wy, feats)
        outs.append(torch.einsum("rxw,rywc->ryxc", wx, tmp))
    return torch.cat(outs)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    fn = _build.library("roi_align.cu").roi_align_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(features, boxes, box_indices, output_size, spatial_scale, sampling_ratio,
            aligned):
    fn = _library()
    n, h, w, c = features.shape
    r = boxes.shape[0]
    oh, ow = output_size
    dev = features.device
    feats = features.contiguous()
    bx = boxes.float().contiguous()
    idx = box_indices.to(torch.int32).contiguous()
    out = torch.empty((r, oh, ow, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(feats.data_ptr(), bx.data_ptr(), idx.data_ptr(), out.data_ptr(),
                n, h, w, c, r, oh, ow, spatial_scale, sampling_ratio, int(aligned),
                _DTYPES[feats.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed: CUDA error {rc}")
    return out


def roi_align(features, boxes, box_indices, output_size=(7, 7), spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True):
    """RoI-Align: ``features [N,H,W,C]`` (float32 or bfloat16), ``boxes
    [R,4]`` xyxy in input coordinates, ``box_indices [R]`` in ``[0, N)`` ->
    ``[R, oh, ow, C]`` float32.

    A CPU tensor runs ``roi_align_reference``; a CUDA tensor launches the
    kernel (counted in ``roi_align.launches``) or raises.
    """
    if sampling_ratio < 1:
        raise ValueError("roi_align needs an explicit sampling_ratio >= 1")
    if features.dim() != 4 or boxes.shape != (box_indices.shape[0], 4):
        raise ValueError(f"roi_align expects features [N,H,W,C], boxes [R,4] and indices "
                         f"[R], got {tuple(features.shape)}, {tuple(boxes.shape)}, "
                         f"{tuple(box_indices.shape)}")
    if features.dtype not in _DTYPES:
        raise TypeError(f"roi_align takes float32 or bfloat16 features, got {features.dtype}")
    output_size = tuple(output_size)
    if features.device.type == "cpu":
        return roi_align_reference(features, boxes, box_indices, output_size,
                                   spatial_scale, sampling_ratio, aligned)
    if features.device.type != "cuda":
        raise RuntimeError(f"roi_align has no kernel for device {features.device}")
    if boxes.shape[0] == 0 or features.shape[-1] == 0:
        return torch.zeros((boxes.shape[0],) + output_size + (features.shape[-1],),
                           dtype=torch.float32, device=features.device)
    out = _launch(features, boxes, box_indices, output_size, spatial_scale,
                  sampling_ratio, aligned)
    roi_align.launches += 1
    return out


roi_align.launches = 0

"""RoI-Align with torchvision semantics on NHWC features.

Port of ``instancesegmentation_tpu/ops/roi_align.py`` (``roi_align`` and the
Pallas kernel ``roi_align_pallas``).  Every output bin is the mean of
``sampling_ratio**2`` bilinear samples; ``aligned=True`` applies the -0.5
half-pixel offset, ``aligned=False`` clamps the ROI size to at least 1; a
sample centre counts only if it lies in ``[-1, size]`` (a NaN centre, from a
NaN box coordinate or from ``-inf + inf``, does not) and is then clamped to
``[0, size - 1]``; a centre that does not count contributes zero.  A box
index follows JAX's gather: a negative one wraps once (``i + N``), then it
is clamped to ``[0, N - 1]``.  The adaptive ratio (``sampling_ratio <= 0``
in torchvision) is not supported, as in the JAX function.

A CPU tensor runs ``roi_align_reference``, the JAX package's separable form
``Wy . feat . Wx^T`` per ROI, over chunks of ROIs so that the gathered
feature maps stay small.  A CUDA tensor runs the kernels of
``csrc/roi_align.cu``: the gather (a block per ROI and output row, taps
read straight from global memory through L1, streaming output stores),
after a locality order of the ROIs by (image, band of the map) from
``ORDER_MIN_ROIS`` ROIs on.  Each kernel launch is counted in
``roi_align.launches`` and, by kernel, in ``roi_align.launches_by_kernel``
("direct", "order").
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


def gather_index(box_indices: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather rule for the box indices: a negative index wraps once,
    then every index is clamped to ``[0, n - 1]``."""
    idx = box_indices.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def roi_align_reference(features, boxes, box_indices, output_size=(7, 7),
                        spatial_scale: float = 1.0, sampling_ratio: int = 2,
                        aligned: bool = True, chunk: int = REFERENCE_CHUNK):
    """The plain version: ``features [N,H,W,C]``, ``boxes [R,4]`` xyxy in
    input coordinates, ``box_indices [R]`` -> ``[R, oh, ow, C]`` float32."""
    _, h, w, c = features.shape
    oh, ow = output_size
    x0, y0, bin_w, bin_h = _roi_geometry(boxes, output_size, spatial_scale, aligned)
    idx = gather_index(box_indices, features.shape[0])
    outs = [features.new_zeros((0, oh, ow, c), dtype=torch.float32)]
    for s in range(0, boxes.shape[0], chunk):
        sl = slice(s, s + chunk)
        wy = _interp_weights(y0[sl], bin_h[sl], h, oh, sampling_ratio)  # [r, oh, H]
        wx = _interp_weights(x0[sl], bin_w[sl], w, ow, sampling_ratio)  # [r, ow, W]
        feats = features[idx[sl]].float()                               # [r, H, W, C]
        tmp = torch.einsum("ryh,rhwc->rywc", wy, feats)
        outs.append(torch.einsum("rxw,rywc->ryxc", wx, tmp))
    return torch.cat(outs)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes

#: The gather takes the ROIs in the locality order from this many on: on an
#: H100 the order's extra launch costs more than it saves at 100 ROIs (7x7
#: and 14x14 poolers), ties at 200-300 (7x7) and wins from 200 (14x14) and
#: 400 (7x7) (``profile_port.py --detection``, PERF.md)
ORDER_MIN_ROIS = 200
ORDER_BANDS = 16       # bands of the map in the order's key (RA_ORDER_BANDS in the source)


def _library():
    from instancesegmentation_tpu_torch.ops import _build

    lib = _build.library("roi_align.cu")
    if lib.roi_align_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.roi_align_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p]
        lib.roi_align_launch.restype = ctypes.c_int
    return lib


def _launch(features, boxes, box_indices, output_size, spatial_scale, sampling_ratio,
            aligned, order=None):
    """Launch the kernels: the locality order where ``order`` is true
    (``None``: from ``ORDER_MIN_ROIS`` ROIs on), then the gather.  Counts
    each launch in ``roi_align.launches`` and ``roi_align.launches_by_kernel``."""
    lib = _library()
    n, h, w, c = features.shape
    r = boxes.shape[0]
    oh, ow = output_size
    dev = features.device
    feats = features.contiguous()
    bx = boxes.float().contiguous()
    idx = box_indices.to(torch.int32).contiguous()
    out = torch.empty((r, oh, ow, c), dtype=torch.float32, device=dev)
    if order is None:
        order = r >= ORDER_MIN_ROIS
    scratch = torch.empty(r, dtype=torch.int32, device=dev) if order else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.roi_align_launch(
            feats.data_ptr(), bx.data_ptr(), idx.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(), n, h, w, c, r, oh,
            ow, spatial_scale, sampling_ratio, int(aligned), _DTYPES[feats.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed: CUDA error {rc}")
    roi_align.launches_by_kernel["direct"] += 1
    roi_align.launches_by_kernel["order"] += int(order)
    roi_align.launches += 1 + int(order)
    return out


def roi_align(features, boxes, box_indices, output_size=(7, 7), spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True):
    """RoI-Align: ``features [N,H,W,C]`` (float32 or bfloat16), ``boxes
    [R,4]`` xyxy in input coordinates, ``box_indices [R]`` (JAX's gather
    rule: ``i < 0`` wraps to ``i + N``, then a clamp to ``[0, N - 1]``) ->
    ``[R, oh, ow, C]`` float32.

    A CPU tensor runs ``roi_align_reference``; a CUDA tensor launches the
    kernels (each launch counted in ``roi_align.launches`` and, by kernel, in
    ``roi_align.launches_by_kernel``) or raises.
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
    return _launch(features, boxes, box_indices, output_size, spatial_scale, sampling_ratio,
                   aligned)


roi_align.launches = 0
roi_align.launches_by_kernel = {"direct": 0, "order": 0}

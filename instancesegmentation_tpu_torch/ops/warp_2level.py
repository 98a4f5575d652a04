"""The two-level rotated resampler of the training pipeline, as CUDA kernels.

Port of the Pallas TPU kernels ``tools/rot_pallas_probe.py``
(``warp_2level_pallas``, two passes, and ``warp_2level_pallas_fused``, one
program per sample) and of its ``_coeffs``.  Both compute
``ops/warp.py:warp_image_rotated_2level`` of the canvas and its instance mask
together: ``image [B,H,W,3]`` uint8 and ``mask [B,H,W]`` uint8 -> ``[B, out_h,
out_w, 4]`` float32 (RGB, then the mask), the translation cut applied to the
content first, as the plain version (and the XLA sampler that training runs)
does.  The probe kernels instead mask the hat taps after the residual shift;
the two agree only where no translation cut is active
(``tests/test_torch_port_rotation.py`` shows both facts).

A CPU tensor runs ``warp_2level_reference``.  A CUDA tensor launches the
kernels of ``csrc/warp_2level.cu`` or raises: ``warp_2level`` is one pass-1
and one pass-2 launch per call (each counted in ``warp_2level.launches``),
``warp_2level_fused`` one launch (``warp_2level_fused.launches``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from instancesegmentation_tpu_torch.ops.nms import _on_card
from instancesegmentation_tpu_torch.ops.warp import (
    SRC_PAD,
    RotWarpParams,
    _affine_terms,
    two_level_bands,
    warp_image_rotated_2level,
)


def coefficients(params: RotWarpParams) -> torch.Tensor:
    """The per-sample terms of the two passes as one ``[B, 16]`` float32
    tensor: ``Ax, Bx, Cx`` and the x cut ``[max(0, lo_x), hi_x)`` (pass 1),
    ``m00, m01, ky0`` and the y cut (pass 2), ``a_y, b_y, a_x, b_x`` and
    ``canvas_hw`` (the rotation cut).  The probe's ``_coeffs`` plus the
    canvas size, which the probe took from the array shape."""
    k = _affine_terms(params)
    return torch.stack([
        k["Ax"], k["Bx"], k["Cx"],
        torch.clamp_min(params.src_lo[:, 1], 0.0), params.src_hi[:, 1],
        k["m00"], k["m01"], k["ky0"],
        torch.clamp_min(params.src_lo[:, 0], 0.0), params.src_hi[:, 0],
        k["a_y"], k["b_y"], k["a_x"], k["b_x"],
        params.canvas_hw[:, 0], params.canvas_hw[:, 1],
    ], dim=1).float().contiguous()


def _check(image: torch.Tensor, mask: torch.Tensor, params: RotWarpParams) -> None:
    if image.dim() != 4 or image.shape[-1] != 3 or mask.shape != image.shape[:3]:
        raise ValueError(f"warp_2level expects image [B,H,W,3] and mask [B,H,W], got "
                         f"{tuple(image.shape)} and {tuple(mask.shape)}")
    if image.dtype != torch.uint8 or mask.dtype != torch.uint8:
        raise TypeError(f"warp_2level takes uint8 canvases and masks, got {image.dtype} "
                        f"and {mask.dtype}")
    if image.device != mask.device or any(f.device != image.device for f in params):
        raise ValueError("warp_2level: image, mask and params lie on different devices")
    if any(f.shape != (image.shape[0], 2) for f in params):
        raise ValueError("warp_2level: every params field must be [B, 2]")


def warp_2level_reference(image, mask, params: RotWarpParams, out_hw, theta_max_deg: float,
                          block: int = 16, scale_x_max: Optional[float] = None) -> torch.Tensor:
    """The plain version: ``warp_image_rotated_2level`` of the float
    RGB + mask concat -> ``[B, out_h, out_w, 4]`` float32."""
    both = torch.cat([image.float(), mask[..., None].float()], dim=-1)
    return warp_image_rotated_2level(both, params, tuple(out_hw), theta_max_deg,
                                     scale_x_max, block)


def _library(name: str, n_ints: int, n_bufs: int):
    from instancesegmentation_tpu_torch.ops import _build

    fn = getattr(_build.library("warp_2level.cu"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_bufs + [i] * n_ints + [p]
        fn.restype = ctypes.c_int
    return fn


def _prepare(image, mask, params, out_hw, theta_max_deg, block, scale_x_max):
    """Checks, bands and buffers of a launch: ``(dims, tmp, out, coefs)``."""
    _check(image, mask, params)
    b, h, w, _ = image.shape
    out_h, out_w = out_hw
    if scale_x_max is None:
        scale_x_max = (w + 2 * SRC_PAD) / out_w
    d1, d2 = two_level_bands(theta_max_deg, block, scale_x_max)
    dev = image.device
    coefs = coefficients(params)
    tmp = torch.empty((b, h, out_w, 4), dtype=torch.float32, device=dev)
    out = torch.empty((b, out_h, out_w, 4), dtype=torch.float32, device=dev)
    return (b, h, w, out_h, out_w, block, d1, d2), tmp, out, coefs


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def warp_2level(image: torch.Tensor, mask: torch.Tensor, params: RotWarpParams, out_hw,
                theta_max_deg: float, block: int = 16,
                scale_x_max: Optional[float] = None) -> torch.Tensor:
    """Two-level rotated warp of ``image [B,H,W,3]`` uint8 and ``mask [B,H,W]``
    uint8 through ``params`` -> ``[B, out_h, out_w, 4]`` float32.

    A CPU tensor runs ``warp_2level_reference``; a CUDA tensor launches the
    pass-1 and pass-2 kernels (each counted in ``warp_2level.launches``) or
    raises.  ``theta_max_deg`` (DEGREES, in (0, 60)) must bound the sampled
    |theta|.
    """
    out_hw = tuple(out_hw)
    if not _on_card(image, "warp_2level"):
        _check(image, mask, params)
        return warp_2level_reference(image, mask, params, out_hw, theta_max_deg, block,
                                     scale_x_max)
    dims, tmp, out, coefs = _prepare(image, mask, params, out_hw, theta_max_deg, block,
                                     scale_x_max)
    img, msk = image.contiguous(), mask.contiguous()
    pass1 = _library("warp_2level_pass1", 8, 4)
    pass2 = _library("warp_2level_pass2", 8, 3)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        _raise_on(pass1(img.data_ptr(), msk.data_ptr(), coefs.data_ptr(), tmp.data_ptr(),
                        *dims, stream), "warp_2level pass 1")
        warp_2level.launches += 1
        _raise_on(pass2(tmp.data_ptr(), coefs.data_ptr(), out.data_ptr(), *dims, stream),
                  "warp_2level pass 2")
        warp_2level.launches += 1
    return out


warp_2level.launches = 0


def warp_2level_fused(image: torch.Tensor, mask: torch.Tensor, params: RotWarpParams, out_hw,
                      theta_max_deg: float, block: int = 16,
                      scale_x_max: Optional[float] = None) -> torch.Tensor:
    """``warp_2level`` in one launch (a thread-block cluster per sample, tmp
    in a global scratch); counted in ``warp_2level_fused.launches``.  A CPU
    tensor runs ``warp_2level_reference``."""
    out_hw = tuple(out_hw)
    if not _on_card(image, "warp_2level_fused"):
        _check(image, mask, params)
        return warp_2level_reference(image, mask, params, out_hw, theta_max_deg, block,
                                     scale_x_max)
    dims, tmp, out, coefs = _prepare(image, mask, params, out_hw, theta_max_deg, block,
                                     scale_x_max)
    img, msk = image.contiguous(), mask.contiguous()
    fused = _library("warp_2level_fused", 8, 5)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        _raise_on(fused(img.data_ptr(), msk.data_ptr(), coefs.data_ptr(), tmp.data_ptr(),
                        out.data_ptr(), *dims, stream), "warp_2level_fused")
        warp_2level_fused.launches += 1
    return out


warp_2level_fused.launches = 0

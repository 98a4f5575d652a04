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
kernels of ``csrc/warp_2level.cu`` or raises: ``warp_2level`` is one launch
of the tiled kernel per call (counted in ``warp_2level.launches``), each CTA
one output tile whose pass-1 rows stay in shared memory, laid out by
``plan_tiles``; ``warp_2level_fused`` is one launch of the sweep
(``warp_2level_fused.launches``), each CTA one sample and strip of output
columns swept down the output rows with its pass-1 rows in a shared-memory
ring, laid out by ``plan_sweep``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

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
    canvas size, which the probe took from the array shape.  The kernels
    compute the same terms from the params themselves
    (``csrc/warp_2level.cu:sample_coefs``), in this order."""
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


#: output columns per CTA of the tiled kernel (``csrc/warp_2level.cu:W2_TILE_V``)
TILE_V = 32
#: shared memory per tile row: TILE_V float4 tmp values (RGB + mask) and the
#: row's pass-1 terms (``csrc/warp_2level.cu:W2_ROW_TERMS_BYTES``)
ROW_BYTES = TILE_V * 16 + 32
#: the plan's shared memory per CTA: three CTAs per SM of an H100
PLAN_SMEM_BYTES = 75 * 1024
#: the most shared memory a CTA can take on an H100
MAX_SMEM_BYTES = 227 * 1024


class TilePlan(NamedTuple):
    """The tiled kernel's layout: CTAs of ``tile_u x TILE_V`` output pixels,
    each holding ``cap_rows`` rows of tmp (``smem_bytes``, ``ROW_BYTES`` a
    row) in shared memory; ``grid`` is (column tiles, row tiles) per sample."""

    tile_u: int
    cap_rows: int
    smem_bytes: int
    grid: tuple


def _centre_spread(out_w: int, block: int, width: int = TILE_V) -> int:
    """The largest spread of block centres over the columns of one tile (or
    strip) of ``width`` columns."""
    return max((min(v0 + width, out_w) - 1) // block * block - v0 // block * block
               for v0 in range(0, out_w, width))


@functools.lru_cache(maxsize=64)
def plan_tiles(theta_max_deg: float, block: int, scale_x_max: float, out_hw) -> TilePlan:
    """The tile shape of the tiled kernel from bounds the wrapper knows, with
    no read of the per-sample coefficients: |theta| <= ``theta_max_deg`` and
    |a_y|, |a_x| <= ``scale_x_max``.  Pass 2 of ``tu`` output rows reads
    canvas rows ``floor(upos_min) - d2 .. floor(upos_max) + 2 + d2`` with
    ``upos_max - upos_min <= |m00| (tu - 1) + |m01| * centre spread``, so at
    most ``floor(s (tu - 1) + s sin(theta) spread) + 2 d2 + 4`` rows.  Takes
    the ``tu`` that computes the fewest pass-1 rows in all (row tiles x rows)
    within ``PLAN_SMEM_BYTES``; a sample beyond the bounds is split into
    sub-tiles by the kernel itself."""
    out_h, out_w = out_hw
    _, d2 = two_level_bands(theta_max_deg, block, scale_x_max)
    s = abs(float(scale_x_max))
    spread = s * math.sin(math.radians(abs(float(theta_max_deg)))) * _centre_spread(out_w, block)

    def rows(tu: int) -> int:
        return math.floor(s * (tu - 1) + spread) + 2 * d2 + 4

    cap_max = PLAN_SMEM_BYTES // ROW_BYTES
    fits = [tu for tu in range(1, out_h + 1) if rows(tu) <= cap_max]
    if fits:
        tile_u = min(fits, key=lambda tu: (-(-out_h // tu) * rows(tu), -tu))
        cap = rows(tile_u)
    else:  # not even one row fits: the largest buffer, single-row sub-tiles
        tile_u = 1
        cap = min(rows(1), MAX_SMEM_BYTES // ROW_BYTES)
    return TilePlan(tile_u, cap, cap * ROW_BYTES,
                    (-(-out_w // TILE_V), -(-out_h // tile_u)))


def _library(name: str, n_ints: int, n_bufs: int):
    from instancesegmentation_tpu_torch.ops import _build

    fn = getattr(_build.library("warp_2level.cu"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_bufs + [i] * n_ints + [p]
        fn.restype = ctypes.c_int
    return fn


def _prepare(image, mask, params, out_hw, theta_max_deg, block, scale_x_max):
    """Checks, bands and buffers of a launch: ``(dims, out, table,
    scale_x_max)``, ``table`` the params' fields as one ``[8, B, 2]`` float32
    tensor, from which the kernels compute ``coefficients`` themselves."""
    _check(image, mask, params)
    b, h, w, _ = image.shape
    out_h, out_w = out_hw
    if scale_x_max is None:
        scale_x_max = (w + 2 * SRC_PAD) / out_w
    d1, d2 = two_level_bands(theta_max_deg, block, scale_x_max)
    table = torch.stack(tuple(params)).float()
    out = torch.empty((b, out_h, out_w, 4), dtype=torch.float32, device=image.device)
    return (b, h, w, out_h, out_w, block, d1, d2), out, table, scale_x_max


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _tiled(image, mask, params: RotWarpParams, out_hw, theta_max_deg: float, block: int,
           scale_x_max: Optional[float], plan: Optional[TilePlan] = None) -> torch.Tensor:
    """One launch of the tiled kernel on CUDA tensors, laid out by ``plan``
    (default ``plan_tiles``), counted in ``warp_2level.launches``."""
    dims, out, table, scale_x_max = _prepare(image, mask, params, out_hw, theta_max_deg,
                                             block, scale_x_max)
    if plan is None:
        plan = plan_tiles(float(theta_max_deg), block, float(scale_x_max), tuple(out_hw))
    img, msk = image.contiguous(), mask.contiguous()
    tiled = _library("warp_2level_tiled", 10, 4)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        _raise_on(tiled(img.data_ptr(), msk.data_ptr(), table.data_ptr(), out.data_ptr(),
                        *dims, plan.tile_u, plan.cap_rows, stream), "warp_2level")
        warp_2level.launches += 1
    return out


def warp_2level(image: torch.Tensor, mask: torch.Tensor, params: RotWarpParams, out_hw,
                theta_max_deg: float, block: int = 16,
                scale_x_max: Optional[float] = None) -> torch.Tensor:
    """Two-level rotated warp of ``image [B,H,W,3]`` uint8 and ``mask [B,H,W]``
    uint8 through ``params`` -> ``[B, out_h, out_w, 4]`` float32.

    A CPU tensor runs ``warp_2level_reference``; a CUDA tensor launches the
    tiled kernel once (counted in ``warp_2level.launches``) or raises.
    ``theta_max_deg`` (DEGREES, in (0, 60)) must bound the sampled |theta|.
    """
    out_hw = tuple(out_hw)
    if not _on_card(image, "warp_2level"):
        _check(image, mask, params)
        return warp_2level_reference(image, mask, params, out_hw, theta_max_deg, block,
                                     scale_x_max)
    return _tiled(image, mask, params, out_hw, theta_max_deg, block, scale_x_max)


warp_2level.launches = 0


#: output columns per CTA of the sweep (``csrc/warp_2level.cu:W2_SWEEP_S``)
SWEEP_STRIP = 64
#: the sweep's plan shared memory per CTA: two CTAs per SM of an H100 (the
#: 256 CTAs of 32 x 640 -> 480 all resident)
SWEEP_SMEM_BYTES = 112 * 1024
#: the most output rows a step of the sweep takes
SWEEP_CHUNK_MAX = 32
#: bytes of a staged canvas row's entry in the stage table (``StageRow``)
STAGE_ROW_BYTES = 32
#: the stage buffers' two transaction barriers (``W2_SWEEP_BARRIER_BYTES``)
SWEEP_BARRIER_BYTES = 16


class SweepPlan(NamedTuple):
    """The sweep's layout: CTAs of ``strip`` (``SWEEP_STRIP``) output
    columns of one sample,
    stepping ``chunk_u`` output rows at a time; ``ring_rows`` rows of tmp
    in shared memory; two stage buffers of ``stage_rows`` canvas rows, each
    ``stage_rgb`` RGB and ``stage_mask`` mask bytes (multiples of 16);
    ``grid`` is (strips,) per sample.  The ring holds two more rows, which
    mirror its first two."""

    strip: int
    chunk_u: int
    ring_rows: int
    stage_rows: int
    stage_rgb: int
    stage_mask: int
    grid: tuple

    @property
    def smem_bytes(self) -> int:
        return (SWEEP_BARRIER_BYTES + (self.ring_rows + 2) * self.strip * 16
                + 2 * self.stage_rows * (STAGE_ROW_BYTES + self.stage_rgb + self.stage_mask))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=64)
def plan_sweep(theta_max_deg: float, block: int, scale_x_max: float, out_hw) -> SweepPlan:
    """The sweep's layout from bounds the wrapper knows, with no read of the
    per-sample coefficients: |theta| <= ``theta_max_deg`` and |a_y|, |a_x|
    <= ``scale_x_max``.  A step of ``cu`` output rows reads the band of
    ``rows(cu) = floor(s (cu - 1) + s sin(theta) spread) + 2 d2 + 4`` canvas
    rows (``plan_tiles``' bound), which the ring holds; the band's front
    moves at most ``floor(s cu) + 1`` rows a step, which a stage buffer holds
    (+ 1 for rounding); a canvas row's window over a strip is at most
    ``floor(s / cos(theta) (strip - 1)) + 4`` pixels (+ 1), ``|Ax| = |a_x| /
    cos(theta)``, staged in 16-byte chunks (+ 30 bytes of alignment).  Takes
    the largest step within ``SWEEP_SMEM_BYTES``; a sample beyond the
    bounds is handled by the kernel itself."""
    out_h, out_w = out_hw
    strip = SWEEP_STRIP
    _, d2 = two_level_bands(theta_max_deg, block, scale_x_max)
    s = abs(float(scale_x_max))
    t = math.radians(abs(float(theta_max_deg)))
    spread = s * math.sin(t) * _centre_spread(out_w, block, strip)
    px = math.floor(s / math.cos(t) * (strip - 1)) + 5
    rgb, msk = _round16(3 * px + 30), _round16(px + 30)

    def rows(cu: int) -> int:
        return math.floor(s * (cu - 1) + spread) + 2 * d2 + 4

    def stage_rows(cu: int) -> int:
        return math.floor(s * cu) + 2

    def smem(cu: int, rgb: int, msk: int) -> int:
        return SweepPlan(strip, cu, rows(cu), stage_rows(cu), rgb, msk, ()).smem_bytes

    fits = [cu for cu in range(1, min(out_h, SWEEP_CHUNK_MAX) + 1)
            if smem(cu, rgb, msk) <= SWEEP_SMEM_BYTES]
    grid = (-(-out_w // strip),)
    if fits:
        cu = max(fits)
        return SweepPlan(strip, cu, rows(cu), stage_rows(cu), rgb, msk, grid)
    # not even one row fits: narrow stage rows, the largest ring beside them
    rgb, msk = min(rgb, 1024), min(msk, 512)
    stage = SweepPlan(strip, 1, 0, stage_rows(1), rgb, msk, grid)
    ring = (MAX_SMEM_BYTES - stage.smem_bytes) // (strip * 16)
    return stage._replace(ring_rows=max(1, min(rows(1), ring)))


def _sweep(image, mask, params: RotWarpParams, out_hw, theta_max_deg: float, block: int,
           scale_x_max: Optional[float], plan: Optional[SweepPlan] = None) -> torch.Tensor:
    """One launch of the sweep on CUDA tensors, laid out by ``plan`` (default
    ``plan_sweep``), counted in ``warp_2level_fused.launches``.  Allocates the
    output alone: the params fields go to the kernel as they are (float32
    and contiguous in the training path)."""
    _check(image, mask, params)
    b, h, w, _ = image.shape
    out_h, out_w = out_hw
    if scale_x_max is None:
        scale_x_max = (w + 2 * SRC_PAD) / out_w
    d1, d2 = two_level_bands(theta_max_deg, block, scale_x_max)
    if plan is None:
        plan = plan_sweep(float(theta_max_deg), block, float(scale_x_max), tuple(out_hw))
    out = torch.empty((b, out_h, out_w, 4), dtype=torch.float32, device=image.device)
    fields = [f if f.dtype == torch.float32 and f.is_contiguous() else f.float().contiguous()
              for f in params]
    img, msk = image.contiguous(), mask.contiguous()
    fused = _library("warp_2level_fused", 13, 11)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        _raise_on(fused(img.data_ptr(), msk.data_ptr(), *(f.data_ptr() for f in fields),
                        out.data_ptr(), b, h, w, out_h, out_w, block, d1, d2, plan.chunk_u,
                        plan.ring_rows, plan.stage_rows, plan.stage_rgb, plan.stage_mask,
                        stream), "warp_2level_fused")
        warp_2level_fused.launches += 1
    return out


def warp_2level_fused(image: torch.Tensor, mask: torch.Tensor, params: RotWarpParams, out_hw,
                      theta_max_deg: float, block: int = 16,
                      scale_x_max: Optional[float] = None) -> torch.Tensor:
    """``warp_2level`` in one launch of the sweep (a CTA per sample and
    strip of output columns, tmp in a shared-memory ring); counted in
    ``warp_2level_fused.launches``.  A CPU tensor runs
    ``warp_2level_reference``."""
    out_hw = tuple(out_hw)
    if not _on_card(image, "warp_2level_fused"):
        _check(image, mask, params)
        return warp_2level_reference(image, mask, params, out_hw, theta_max_deg, block,
                                     scale_x_max)
    return _sweep(image, mask, params, out_hw, theta_max_deg, block, scale_x_max)


warp_2level_fused.launches = 0

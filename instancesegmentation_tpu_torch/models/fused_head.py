"""Algebraic fusion of the Segment output head (section 6).

Port of ``instancesegmentation_tpu/models/fused_head.py``.  The head is
linear: ``bottle6_1`` (ConvTranspose k8 s4 p2, 16->4) feeds ``bottle6_2``
(raw Conv 3x3 p1, 4->1) with no activation in between, so the two compose
into one stride-4 transposed conv with a 10x10 kernel.  That composite is
run as one ordinary 3x3 conv with S*S phase output channels at low
resolution followed by a pixel shuffle, which never materialises the
``[N,4,4H,4W]`` intermediate.

The composition is exact except on the outermost 1-px ring of the output,
where ``bottle6_2``'s zero padding sees true zeros in the unfused head.
``head_apply`` recomputes the four border lines with width-3 conv1ds of the
adjacent input line (plus per-corner dot products) and adds the
exact-minus-composite difference there.

Every kernel and bias is measured from impulse responses of the real
two-op head.  Serving folds once per weight assignment, in float64 on the
CPU (``fold_head``); training folds from the live parameters at every step,
on their device and in their dtype, differentiably, so gradients reach
``bottle6_1`` and ``bottle6_2`` (``fold_head_live``).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

K1 = 8  # bottle6_1 kernel
S = 4   # bottle6_1 stride
P1 = 2  # bottle6_1 padding
K2 = 3  # bottle6_2 kernel
P2 = 1  # bottle6_2 padding
KC = K1 + K2 - 1  # composite kernel size (10)
PC = K1 - 1 - P1 + K2 - 1 - P2  # composite conv-side padding (6)


class FoldedHead(NamedTuple):
    phase_kernel: torch.Tensor  # [S*S, C, 3, 3] per-output-phase conv
    bias: torch.Tensor          # [] interior bias
    row_kernel: torch.Tensor    # [2S, 2C, 1, 3] top (+) bottom edge conv1d
    col_kernel: torch.Tensor    # [2S, 2C, 3, 1] left (+) right edge conv1d
    bias_rows: torch.Tensor     # [2, 3] (top/bottom) x (corner_l, interior, corner_r)
    bias_cols: torch.Tensor     # [2] left/right interior-of-edge bias
    corner_w: torch.Tensor      # [4, C] tl/tr/bl/br corner-pixel weights

    def to(self, device) -> "FoldedHead":
        """float32 copy on ``device``; ``head_apply`` casts to its dtype."""
        return FoldedHead(*(t.to(device=device, dtype=torch.float32) for t in self))


def _head(x, w1, b1, w2, b2):
    """The unfused head on NCHW ``x``; ``None`` biases give its linear part."""
    y = F.conv_transpose2d(x, w1, b1, stride=S, padding=P1)
    return F.conv2d(y, w2, b2, padding=P2)


def fold_head(state_dict: Mapping[str, torch.Tensor]) -> FoldedHead:
    """Build the composite head from ``bottle6_1`` / ``bottle6_2`` of a
    port state dict, in float64 on the CPU (serving)."""
    def get(k):
        return state_dict[k].detach().to("cpu", torch.float64)

    return _fold(get("bottle6_1.weight"), get("bottle6_1.bias"),
                 get("bottle6_2.weight"), get("bottle6_2.bias"))


def fold_head_live(model) -> FoldedHead:
    """The composite head of ``model`` (a Segment) from its live parameters,
    on their device and in their dtype, differentiable (training)."""
    return _fold(model.bottle6_1.weight, model.bottle6_1.bias,
                 model.bottle6_2.weight, model.bottle6_2.bias)


def _phase_index():
    """Gather indices of the phase decomposition: output pixel
    (S*u+py, S*v+px) = sum_t kc[S*t - p + PC] x[u+t], t in {-1,0,1}, so
    phase (py, px) at tap (ky, kx) reads kc[UY[py, ky], UX[px, kx]]; an
    index of KC reads the zero pad."""
    t = torch.arange(3)
    p = torch.arange(S)
    u = S * (t[None, :] - 1) - p[:, None] + PC        # [S, 3]
    return torch.where((u >= 0) & (u < KC), u, torch.full_like(u, KC))


def _fold(w1, b1, w2, b2) -> FoldedHead:
    """The composite head of the two-op head with ConvTranspose weights
    ``w1 [C,4,8,8]``, ``b1 [4]`` and conv weights ``w2 [1,4,3,3]``, ``b2 [1]``,
    in their dtype and on their device."""
    dt, dev = w1.dtype, w1.device
    c_in = w1.shape[0]
    eye = torch.arange(c_in, device=dev)

    # impulse at the centre of a canvas large enough that neither the
    # response support nor conv padding reaches the borders
    canvas = 2 * KC
    ctr = canvas // 2
    x = torch.zeros(c_in, c_in, canvas, canvas, dtype=dt, device=dev)
    x[eye, eye, ctr, ctr] = 1.0
    out = _head(x, w1, None, w2, None)[:, 0]  # [C, S*canvas, S*canvas]

    # response g[c, dy, dx] around output position S*ctr, and the
    # conv-ready composite kc[c, u, v] = g[c, PC-u, PC-v]
    lo = S * ctr - (KC - 1)
    g = out[:, lo:lo + 2 * KC - 1, lo:lo + 2 * KC - 1]
    idx = (PC - torch.arange(KC, device=dev)) + (KC - 1)
    kc = g[:, idx][:, :, idx]  # [C, KC, KC]

    # phase decomposition: one 3x3 conv with S*S phase output channels,
    # then a pixel shuffle
    idx = _phase_index().to(dev)
    kcp = F.pad(kc, (0, 1, 0, 1))                        # [C, KC+1, KC+1]
    pk = kcp[:, idx[:, None, :, None], idx[None, :, None, :]]  # [C, py, px, ky, kx]
    pk = pk.reshape(c_in, S * S, 3, 3).transpose(0, 1)

    # interior bias: the real head on zeros, read at an interior pixel
    z = torch.zeros(1, c_in, canvas, canvas, dtype=dt, device=dev)
    bias = _head(z, w1, b1, w2, b2)[0, 0, S * ctr, S * ctr]

    edges = _edge_maps(w1, b1, w2, b2)
    return FoldedHead(pk, bias, *edges)


def _edge_maps(w1, b1, w2, b2):
    """The exact affine maps (input edge line) -> (output edge line) of
    the unfused head, measured from impulses.

    Output row 0 depends only on input row 0, and both head convs are
    translation-invariant maps of zero-extended inputs, so each border
    line of the output is a width-3 conv1d of the adjacent input line
    (S phase outputs per position) plus a bias profile that is constant
    along the line except at its two corner pixels.  At a corner the
    unfused head reads a zero-padded column, so each corner pixel gets
    its own [C] dot weight.
    """
    c_in = w1.shape[0]
    dt, dev = w1.dtype, w1.device
    W0 = 12  # canvas: centre responses must clear the corners
    ctr = W0 // 2
    eye = torch.arange(c_in, device=dev)

    def run(x):
        return _head(x, w1, b1, w2, b2)[:, 0]

    base = run(torch.zeros(1, c_in, W0, W0, dtype=dt, device=dev))[0]
    bias_rows = torch.stack([
        torch.stack([base[0, 0], base[0, S * ctr], base[0, -1]]),
        torch.stack([base[-1, 0], base[-1, S * ctr], base[-1, -1]]),
    ])
    bias_cols = torch.stack([base[S * ctr, 0], base[S * ctr, -1]])

    # edge-centre impulses (top, bottom, left, right) and corner impulses
    # (tl, tr, bl, br), c_in canvases each
    imp = torch.zeros(8 * c_in, c_in, W0, W0, dtype=dt, device=dev)
    for i, (yy, xx) in enumerate([(0, ctr), (-1, ctr), (ctr, 0), (ctr, -1),
                                  (0, 0), (0, -1), (-1, 0), (-1, -1)]):
        imp[i * c_in + eye, eye, yy, xx] = 1.0
    resp = run(imp)  # [8C, S*W0, S*W0]

    corner_w = torch.stack([
        resp[4 * c_in:5 * c_in, 0, 0] - base[0, 0],
        resp[5 * c_in:6 * c_in, 0, -1] - base[0, -1],
        resp[6 * c_in:7 * c_in, -1, 0] - base[-1, 0],
        resp[7 * c_in:, -1, -1] - base[-1, -1],
    ])

    # out[0, S*v+p] = sum_d T[d, c, p] x[0, v+d-1, c]: an impulse at column
    # ctr lands at v = ctr+1-d, so T[d, c, p] = r[c, S*(ctr+1-d)+p]
    def gather(lines, bias_line):  # [C, S*W0] -> [3, C, S]
        r = lines - bias_line
        return torch.stack(
            [r[:, S * (ctr + 1 - d):S * (ctr + 2 - d)] for d in range(3)]
        )

    def block_diag(ta, tb):  # [3,C,S] x2 -> [3, 2C, 2S]
        z = torch.zeros_like(ta)
        return torch.cat(
            [torch.cat([ta, z], dim=2), torch.cat([z, tb], dim=2)], dim=1
        )

    rows = block_diag(gather(resp[:c_in, 0, :], base[0, :]),
                      gather(resp[c_in:2 * c_in, -1, :], base[-1, :]))
    cols = block_diag(gather(resp[2 * c_in:3 * c_in, :, 0], base[:, 0]),
                      gather(resp[3 * c_in:4 * c_in, :, -1], base[:, -1]))
    row_kernel = rows.permute(2, 1, 0)[:, :, None, :]  # [2S, 2C, 1, 3]
    col_kernel = cols.permute(2, 1, 0)[:, :, :, None]  # [2S, 2C, 3, 1]
    return row_kernel, col_kernel, bias_rows, bias_cols, corner_w


def _edge_lines(x, head: FoldedHead, dtype):
    """Exact output border lines of ``x [N,h,w,C]``.

    Returns top, bot ``[N, S*w]`` (corners exact) and left, right
    ``[N, S*h]`` whose outermost P2 entries carry the interior-of-edge bias
    (the caller drops them; the row lines own the corners).
    """
    n, h, w, _ = x.shape
    xd = x.to(dtype)

    rows_in = torch.cat([xd[:, 0], xd[:, -1]], dim=-1)  # [N, w, 2C]
    rows_out = F.conv2d(rows_in.permute(0, 2, 1)[:, :, None, :],
                        head.row_kernel.to(dtype), padding=(0, 1))
    rows_out = rows_out[:, :, 0, :].permute(0, 2, 1)  # [N, w, 2S]
    br = head.bias_rows.to(dtype)

    def profile(b3, length):
        p = torch.full((length,), 0.0, dtype=dtype, device=x.device) + b3[1]
        p[0], p[-1] = b3[0], b3[2]
        return p

    top = rows_out[..., :S].reshape(n, S * w) + profile(br[0], S * w)
    bot = rows_out[..., S:].reshape(n, S * w) + profile(br[1], S * w)

    cw = head.corner_w.to(dtype)
    top[:, 0] = xd[:, 0, 0] @ cw[0] + br[0, 0]
    top[:, -1] = xd[:, 0, -1] @ cw[1] + br[0, 2]
    bot[:, 0] = xd[:, -1, 0] @ cw[2] + br[1, 0]
    bot[:, -1] = xd[:, -1, -1] @ cw[3] + br[1, 2]

    cols_in = torch.cat([xd[:, :, 0], xd[:, :, -1]], dim=-1)  # [N, h, 2C]
    cols_out = F.conv2d(cols_in.permute(0, 2, 1)[:, :, :, None],
                        head.col_kernel.to(dtype), padding=(1, 0))
    cols_out = cols_out[..., 0].permute(0, 2, 1)  # [N, h, 2S]
    bc = head.bias_cols.to(dtype)
    left = cols_out[..., :S].reshape(n, S * h) + bc[0]
    right = cols_out[..., S:].reshape(n, S * h) + bc[1]
    return top, bot, left, right


def head_apply(x, head: FoldedHead, dtype=torch.float32):
    """Composite head forward: ``x [N,h,w,C] -> logits [N,S*h,S*w,1]`` in
    ``dtype``; equal in exact arithmetic to ``bottle6_2(bottle6_1(x))``.

    The border ring is corrected additively, ``out + (exact - out)``, as
    the JAX package does.
    """
    xd = x.to(dtype)
    conv_out = F.conv2d(xd.permute(0, 3, 1, 2), head.phase_kernel.to(dtype),
                        padding=1)  # [N, S*S, h, w]
    out = F.pixel_shuffle(conv_out, S)[:, 0] + head.bias.to(dtype)

    top, bot, left, right = _edge_lines(x, head, dtype)
    res = out.clone()
    res[:, :P2] = out[:, :P2] + (top[:, None, :] - out[:, :P2])
    res[:, -P2:] = out[:, -P2:] + (bot[:, None, :] - out[:, -P2:])
    inner = slice(P2, out.shape[1] - P2)
    res[:, inner, :P2] = out[:, inner, :P2] + (
        left[:, inner, None] - out[:, inner, :P2])
    res[:, inner, -P2:] = out[:, inner, -P2:] + (
        right[:, inner, None] - out[:, inner, -P2:])
    return res[..., None]

"""The int8 conv kernel's host side (``ops/int8_conv.py``: ``plan``,
``pack_weights``) on the CPU, for every conv geometry of ``Segment(20)`` at
480 px and ``Segment(3)`` at 512 px (input widths 3, 19, 35 and 52
included):

- the plan at batch 128 fits a block's 232,448 bytes of shared memory in
  every input and output type, and pads the dense K as documented
  (``kh * kw * Cp`` with Cp the channels rounded up to 4, the whole a
  multiple of 32: the stem's 500 -> 512);
- a numpy model of ``csrc/int8_conv.cu`` (the quantised tile in shared
  memory, the word-offset table, the ``m16n8k32`` fragments of the implicit
  im2col in K order and of the packed weights, the staged epilogue's
  pixels; the grouped form's runs and taps) gives ``int8_conv_reference``'s
  int32 accumulators exactly on small seeded inputs of odd sizes, with the
  plan's own tile and with an imposed ragged one, on inputs that sit on the
  quantiser's .5 ties and beyond +-127 steps;
- dense convs wider than 128 outputs (129, 136, 256: slices of 128
  channels) through the same model, and every conv of both programs keeps
  the plan and weight layout stored in ``tests/data/int8_model_plans.json``
  (written before the slices were added).
"""
import json
import os

import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.models.layers import _float_conv
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops import int8_conv as ic

torch.set_num_threads(1)
PROGRAMS = ((20, 480), (3, 512))


def _geometries():
    """{(C, out, k, stride, padding, dilation, groups): [H, W] of each use}
    of both programs, traced on the meta device."""
    found = {}
    for cin, size in PROGRAMS:
        model = Segment(cin).to("meta").eval()
        for path, m in model.quant_convs().items():
            def record(mod, x, path=path):
                key = (x.shape[1], mod.out_channels, mod.kernel_size, mod.stride, mod.padding,
                       mod.dilation, mod.groups)
                found.setdefault(key, set()).add(tuple(x.shape[2:]))
                return _float_conv(mod, x)
            m.quant = record
        hm = torch.zeros(1, size, size, cin - 3, device="meta") if cin > 3 else None
        with torch.no_grad():
            model(torch.zeros(1, size, size, 3, device="meta"), hm)
    return found


GEOMETRIES = _geometries()
KEYS = sorted(GEOMETRIES)


def _conv(key, seed: int, amax=2.0) -> ic.Int8Conv:
    c, out, k, stride, padding, dilation, groups = key
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.3, (out, c // groups, *k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, out).astype(np.float32))
    return ic.Int8Conv(w, b, amax, stride, padding, dilation, groups)


def _tie_input(shape, s_in, seed: int) -> torch.Tensor:
    """Values on the quantiser's ties (k + 0.5) * s_in, beyond +-127 steps,
    and in between."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-140, 140, shape).astype(np.float32)
    ties = (k + np.float32(0.5)) * np.float32(s_in)
    free = rng.normal(0, 60 * s_in, shape).astype(np.float32)
    return torch.from_numpy(np.where(rng.random(shape) < 0.5, ties, free))


def test_geometries_cover_the_programs():
    widths = {key[0] for key in KEYS if key[6] == 1}
    assert {3, 19, 35, 52} <= widths
    assert sum(len(v) for v in GEOMETRIES.values()) >= 40
    assert any(key[6] > 1 and key[2] == (5, 1) for key in KEYS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fits_and_pads(dtype):
    for key, sizes in GEOMETRIES.items():
        conv = _conv(key, 0)
        c, out, (kh, kw) = key[0], key[1], key[2]
        for h, w in sizes:
            for out_dtype in (torch.float32, torch.bfloat16, torch.int32):
                p = ic.plan(conv, (128, h, w, c), dtype, out_dtype)
                assert p.smem <= ic.SMEM_MAX == 232448, (key, p)
                ho, wo = conv.out_hw(h, w)
                assert p.tiles_y * p.th >= ho and p.tiles_x * p.tw >= wo
                per_sm = 2 if p.smem + 1024 <= ic.SMEM_PER_SM // 2 else 1
                assert p.blocks == min(128 * p.tiles_y * p.tiles_x, 132 * per_sm), (key, p)
                assert p.ir == (p.th - 1) * key[3][0] + (kh - 1) * key[5][0] + 1
                assert p.ic == (p.tw - 1) * key[3][1] + (kw - 1) * key[5][1] + 1
                if p.form == "dense":
                    assert key[6] == 1 and p.tw % 16 == 0 and p.kp % 32 == 0
                    assert p.kp == -(-kh * kw * (-(-c // 4) * 4) // 32) * 32
                    assert p.kp - kh * kw * (-(-c // 4) * 4) < 32
                    assert p.np % 8 == 0 and out <= p.np <= 128
                    assert (p.pp * key[3][1]) % 8 == 4 and p.pp >= -(-c // 4)
                else:
                    assert key[6] > 1 and p.kp == kh * kw
    stem_conv = _conv((20, 16, (5, 5), (2, 2), (2, 2), (1, 1), 1), 0)
    stem = ic.plan(stem_conv, (128, 480, 480, 20), dtype)
    assert stem.kp == 512 and stem.form == "dense"
    assert len(ic.geometry(stem_conv, (128, 480, 480, 20), stem, True)) == ic.GEOM_INTS
    # a card of 114 SMs: the grid follows its count
    small = ic.plan(stem_conv, (128, 480, 480, 20), dtype, sms=114)
    assert small.blocks == min(128 * small.tiles_y * small.tiles_x, 114 * 2)


def _walk(p, c4: int):
    """The kernel's tile loader walk (``load_tile`` / ``fetch``): each of
    ``THREADS`` threads starts at word ``t`` of the tile in (row, column,
    word) order and steps ``THREADS`` words at a time with carries, until
    its row passes the tile.  Returns every (thread, r, col, c4) taken."""
    per_row, t = p.ic * c4, np.arange(ic.THREADS)
    step = (ic.THREADS // per_row, ic.THREADS % per_row // c4, ic.THREADS % c4)
    r, col, w = t // per_row, t % per_row // c4, t % c4
    taken = []
    while (r < p.ir).any():
        live = r < p.ir
        taken += zip(t[live], r[live], col[live], w[live])
        w = w + step[2]
        carry = w >= c4
        w = np.where(carry, w - c4, w)
        col = col + step[1] + carry
        carry = col >= p.ic
        col = np.where(carry, col - p.ic, col)
        r = r + step[0] + carry
    return taken


@pytest.mark.parametrize("tile", [None, "small"])
def test_tile_walk_takes_each_word_once(tile):
    """The loader's walk covers every word of every plan's tile once, in
    each thread's order of the flat word index (the plan at batch 128 and
    imposed small tiles)."""
    for key, sizes in GEOMETRIES.items():
        conv = _conv(key, 0)
        c4 = -(-key[0] // 4)
        for h, w in sizes:
            imposed = None if tile is None else ((3, 16) if key[6] == 1 else (2, 5))
            p = ic.plan(conv, (128, h, w, key[0]), torch.bfloat16, tile=imposed)
            taken = _walk(p, c4)
            flat = [(r * p.ic + col) * c4 + w4 for _, r, col, w4 in taken]
            assert sorted(flat) == list(range(p.ir * p.ic * c4)), (key, p)
            assert all(f % ic.THREADS == t for (t, *_), f in zip(taken, flat))


def test_plan_refuses_what_it_cannot_hold():
    # any width is held: above 128 outputs in slices of 128 channels
    assert [ic.dense_tiles(c) for c in (4, 17, 49, 128, 129, 136, 256, 257)] == \
        [1, 6, 16, 16, 32, 32, 32, 48]
    assert [ic.dense_slices(c) for c in (4, 128, 129, 256, 257)] == [1, 1, 2, 2, 3]
    conv = _conv((16, 16, (3, 3), (1, 1), (1, 1), (1, 1), 1), 0)
    with pytest.raises(ValueError, match="tile"):
        ic.plan(conv, (1, 9, 9, 16), tile=(2, 24))
    with pytest.raises(ValueError, match="shared memory"):
        ic.plan(conv, (1, 900, 9000, 16), tile=(64, 1024))


# -- the numpy model of the kernel ----------------------------------------------------


def _tile_words(q, n, p, iy0, ix0):
    """The block's quantised tile as shared memory holds it: int32 words
    ``[IR * IC * PP]``, pixel (r, col) at word (r * IC + col) * PP, channels
    past C and pixels outside the image 0."""
    _, h, w, c = q.shape
    c4 = -(-c // 4)
    tile = np.zeros((p.ir, p.ic, p.pp * 4), np.int8)
    for r in range(p.ir):
        iy = iy0 + r
        if not 0 <= iy < h:
            continue
        lo, hi = max(ix0, 0), min(ix0 + p.ic, w)
        if lo < hi:
            tile[r, lo - ix0:hi - ix0, :c] = q[n, iy, lo:hi]
    assert not tile[:, :, 4 * c4:].any()
    return tile.reshape(-1).view(np.int32)


def _bytes(words):
    """int32 words -> their 4 int8 lanes, lowest byte first."""
    return np.ascontiguousarray(words).view(np.int8).reshape(*np.shape(words), 4)


def _unpack_b(packed: np.ndarray, kp: int, nt: int) -> np.ndarray:
    """The B matrix [Kp, 8 NT] that the packed fragments hold, by the PTX
    layout of m16n8k32: b0 of lane (g, t) is k = 4 t + i, b1 k = 16 + 4 t +
    i, both of column n = g."""
    b = np.zeros((kp, 8 * nt), np.int64)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for s in range(kp // 32):
        for j in range(nt):
            for reg in range(2):
                vals = _bytes(packed[s, j, :, reg])
                for i in range(4):
                    b[32 * s + 16 * reg + 4 * t + i, 8 * j + g] = vals[:, i]
    return b


def _mma_a(words_a: np.ndarray) -> np.ndarray:
    """A [16, 32] from the 4 registers of the 32 lanes (PTX m16n8k32 .s8):
    a0 row g cols 4 t + i, a1 row g + 8, a2 row g cols 16 + 4 t + i, a3 row
    g + 8 cols 16 + 4 t + i."""
    a = np.zeros((16, 32), np.int64)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for reg, (drow, dcol) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        vals = _bytes(words_a[:, reg])
        for i in range(4):
            a[g + drow, dcol + 4 * t + i] = vals[:, i]
    return a


def _emulate_dense(q, conv, p):
    n_img, h, w, c = q.shape
    ho, wo = conv.out_hw(h, w)
    (sh, sw), (ph, pw), (dh, dw) = conv.stride, conv.padding, conv.dilation
    slices = ic.dense_slices(conv.out_channels)
    c4, nt = -(-c // 4), p.np // 8 // slices  # a slice's N tiles
    packed = ic.pack_weights(conv.wq, 1).numpy()
    assert packed.shape == (slices * p.kp // 32, nt, 32, 2)
    # each slice's B matrix from its own fragments, side by side
    b = np.concatenate([_unpack_b(part, p.kp, nt) for part in np.split(packed, slices)], axis=1)
    taps = np.arange(p.kp // 4) // c4
    woff = np.where(taps < conv.kh * conv.kw,
                    ((taps // conv.kw) * dh * p.ic + (taps % conv.kw) * dw) * p.pp
                    + np.arange(p.kp // 4) % c4, 0)
    # each (row, channel) of an m-tile staged once by the accumulator
    # registers (lane (g, t), tile j, register k)
    staged = {(g + 8 * (k >> 1), 8 * j + 2 * t + (k & 1))
              for g in range(8) for t in range(4) for j in range(nt) for k in range(4)}
    assert staged == {(r, ch) for r in range(16) for ch in range(8 * nt)}
    out = np.full((n_img, ho, wo, conv.out_channels), -2 ** 40, np.int64)
    writes = np.zeros((n_img, ho, wo, conv.out_channels), np.int64)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for s in range(slices):  # the grid's slowest index
        c0 = 8 * nt * s
        cn = min(8 * nt, conv.out_channels - c0)
        bs = b[:, c0:c0 + 8 * nt]
        for n in range(n_img):
            for ty in range(p.tiles_y):
                for tx in range(p.tiles_x):
                    oy0, ox0 = ty * p.th, tx * p.tw
                    xs = _tile_words(q, n, p, oy0 * sh - ph, ox0 * sw - pw)
                    for mt in range(p.th * p.tw // 16):
                        pix = mt * 16 + np.stack([g, g + 8])  # fragment rows of each lane
                        base = ((pix // p.tw) * sh * p.ic + (pix % p.tw) * sw) * p.pp
                        acc = np.zeros((16, 8 * nt), np.int64)
                        for ks in range(p.kp // 32):
                            o0, o1 = woff[ks * 8 + t], woff[ks * 8 + 4 + t]
                            regs = np.stack([xs[base[0] + o0], xs[base[1] + o0],
                                             xs[base[0] + o1], xs[base[1] + o1]], axis=1)
                            acc += _mma_a(regs) @ bs[32 * ks:32 * ks + 32]
                        r, col0 = divmod(mt * 16, p.tw)
                        oy, ox = oy0 + r, ox0 + col0
                        valid = min(16, wo - ox) if oy < ho else 0
                        if valid > 0:
                            out[n, oy, ox:ox + valid, c0:c0 + cn] = acc[:valid, :cn]
                            writes[n, oy, ox:ox + valid, c0:c0 + cn] += 1
    assert (writes == 1).all(), "every output channel of every pixel written once"
    return out


def _emulate_grouped(q, conv, p):
    n_img, h, w, c = q.shape
    ho, wo = conv.out_hw(h, w)
    (sh, sw), (ph, pw), (dh, dw) = conv.stride, conv.padding, conv.dilation
    cout, cin_g = conv.out_channels, conv.in_per_group
    cout_g = cout // conv.groups
    wg = _bytes(ic.pack_weights(conv.wq, conv.groups).numpy()).reshape(
        conv.kh * conv.kw, cin_g, -1).astype(np.int64)
    assert wg.shape[2] == 4 * p.np
    out = np.full((n_img, ho, wo, cout), -2 ** 40, np.int64)
    writes = np.zeros((n_img, ho, wo), np.int64)
    co = np.arange(cout)
    for n in range(n_img):
        for ty in range(p.tiles_y):
            for tx in range(p.tiles_x):
                oy0, ox0 = ty * p.th, tx * p.tw
                xb = _bytes(_tile_words(q, n, p, oy0 * sh - ph, ox0 * sw - pw)).reshape(-1)
                runs = -(-p.tw // ic.RUN)
                for r in range(p.th):
                    if oy0 + r >= ho:
                        continue
                    ox_l = np.arange(runs * ic.RUN)  # every run's pixels
                    acc = np.zeros((len(ox_l), cout), np.int64)
                    for ky in range(conv.kh):
                        row = (r * sh + ky * dh) * p.ic
                        for kx in range(conv.kw):
                            col = np.minimum(ox_l, p.tw - 1) * sw + kx * dw
                            for ci in range(cin_g):
                                ch = (co // cout_g) * cin_g + ci
                                xv = xb[((row + col) * p.pp * 4)[:, None] + ch[None, :]]
                                acc += xv.astype(np.int64) * wg[ky * conv.kw + kx, ci, :cout]
                    keep = (ox_l < p.tw) & (ox0 + ox_l < wo)
                    out[n, oy0 + r, ox0 + ox_l[keep]] = acc[keep]
                    writes[n, oy0 + r, ox0 + ox_l[keep]] += 1
    assert (writes == 1).all(), "every output pixel written once"
    return out


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"c{k[0]}_o{k[1]}_k{k[2][0]}x{k[2][1]}"
                         f"_s{k[3][0]}_d{k[5][0]}_g{k[6]}")
def test_kernel_model_matches_reference(key):
    """The numpy model of the kernel on [2, 17, 23, C] (and [1, 9, 37, C]
    for the strided convs' ragged columns), with the plan's tile and an
    imposed small one: the reference's int32 accumulators exactly."""
    seed = sum(map(ord, repr(key)))
    conv = _conv(key, seed, amax=1.7)
    for shape in ((2, 17, 23, key[0]), (1, 9, 37, key[0])):
        x = _tie_input(shape, conv.s_in, seed + shape[2])
        want = ic.int8_conv_reference(x, conv, torch.int32).numpy()
        q = ic.quantize_input_reference(x, conv.s_in).numpy()
        assert (np.abs(q) == 127).any()
        emulate = _emulate_dense if key[6] == 1 else _emulate_grouped
        small = (3, 16) if key[6] == 1 else (2, 5)
        for tile in (None, small):
            p = ic.plan(conv, shape, torch.float32, tile=tile)
            np.testing.assert_array_equal(emulate(q, conv, p), want.astype(np.int64),
                                          err_msg=f"{key} {shape} tile {tile}")


def test_grouped_model_general_groups():
    """A grouped conv that is not depthwise (2 inputs and 3 outputs per
    group, 4 groups, 12 channels out) through the grouped model."""
    conv = _conv((8, 12, (3, 3), (1, 1), (1, 1), (1, 1), 4), 5)
    x = _tie_input((2, 7, 11, 8), conv.s_in, 5)
    want = ic.int8_conv_reference(x, conv, torch.int32).numpy()
    q = ic.quantize_input_reference(x, conv.s_in).numpy()
    for tile in (None, (3, 4)):
        p = ic.plan(conv, x.shape, torch.float32, tile=tile)
        np.testing.assert_array_equal(_emulate_grouped(q, conv, p), want)


@pytest.mark.parametrize("key", [(24, 129, (1, 1), (1, 1), (0, 0), (1, 1), 1),
                                 (8, 136, (3, 3), (1, 1), (1, 1), (1, 1), 1),
                                 (16, 256, (1, 1), (1, 1), (0, 0), (1, 1), 1),
                                 (4, 256, (3, 3), (2, 2), (1, 1), (1, 1), 1)],
                         ids=lambda k: f"o{k[1]}_k{k[2][0]}_s{k[3][0]}")
def test_wide_dense_model_matches_reference(key):
    """Dense convs of 129, 136 and 256 outputs run in slices of 128
    channels: the plan's shared memory holds one slice (as a 128-output
    conv's), the grid counts every slice's tiles, and the numpy model gives
    the reference's int32 accumulators with the plan's tile and a small
    one."""
    conv = _conv(key, key[1], amax=1.7)
    slices = -(-key[1] // 128)
    narrow = _conv((key[0], 128, *key[2:]), 0, amax=1.7)
    shape = (2, 11, 19, key[0])
    x = _tie_input(shape, conv.s_in, key[1])
    want = ic.int8_conv_reference(x, conv, torch.int32).numpy().astype(np.int64)
    q = ic.quantize_input_reference(x, conv.s_in).numpy()
    for tile in (None, (3, 16)):
        for out_dtype in (torch.float32, torch.bfloat16):
            p = ic.plan(conv, shape, torch.float32, out_dtype, tile=tile)
            p128 = ic.plan(narrow, shape, torch.float32, out_dtype, tile=(p.th, p.tw))
            assert p.np == 128 * slices and p.smem == p128.smem and p.pitch == p128.pitch
            assert p.blocks == min(slices * 2 * p.tiles_y * p.tiles_x, 132 * 2)
        np.testing.assert_array_equal(_emulate_dense(q, conv, p), want, err_msg=f"tile {tile}")


def test_model_convs_keep_their_plans():
    """Every conv of ``Segment(20)`` at 480 px and ``Segment(3)`` at 512 px,
    at batch 1 and 128, every input and output type: the plan (tile, shared
    memory, grid) and the packed weights' shape stored before convs wider
    than 128 outputs were taken."""
    with open(os.path.join(os.path.dirname(__file__), "data", "int8_model_plans.json")) as f:
        stored = json.load(f)
    got = {}
    for key in sorted(GEOMETRIES):
        conv = _conv(key, 0)
        packed = list(ic.pack_weights(conv.wq, conv.groups).shape)
        for h, w in sorted(GEOMETRIES[key]):
            for n in (1, 128):
                for dt in (torch.float32, torch.bfloat16):
                    for od in (torch.float32, torch.bfloat16, torch.int32):
                        p = ic.plan(conv, (n, h, w, key[0]), dt, od)
                        name = f"{key!r} {[n, h, w, key[0]]} {str(dt)[6:]}->{str(od)[6:]}"
                        got[name] = list(p)[1:] + [packed]
    assert got == stored

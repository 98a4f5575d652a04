"""Write the AVIF fixtures of the port's AVIF decoder, with cv2's decodes
beside them.

    python tests/data/avif/make_fixtures.py

Each ``<name>.avif`` is written by ``cv2.imencode`` or PIL (libavif with
libaom), or edited from their boxes, from seeded pixels:

- cv2's own files: quality 0-100 (100 is lossless 4:4:4 with the identity
  matrix), speed 0-10 (0-4 turn loop restoration on), gray (4:0:0), BGRA
  (an alpha item), odd sides (1 x 1, 2 x 3, 7 x 13, 13 x 7, 17 x 23,
  65 x 129, 129 x 65), larger frames, and flat screen content at speed 2
  (palettes);
- PIL's: 4:4:4, 4:0:0, limited range, lossless, several tiles, and
  libaom's own options (``advanced``) that turn tools on and off: CDEF,
  restoration, filter intra, CfL, smooth and Paeth, angle deltas, the edge
  filter, 64-point and rectangular transforms, the reduced set, quantiser
  matrices, delta q, chroma delta q, sharpness, 128 x 128 superblocks, the
  partition forms; screen content in 4:4:4 (palettes); EXIF orientation
  written as ``irot`` / ``imir``, an EXIF item, one whose orientation is
  6 (cv2 applies none of them), an ICC profile, an XMP item;
- cv2's file with its ``nclx`` box edited: BT.709, BT.2020 and BT.601
  limited, and chroma-derived matrices; and with a property added
  (``add_property``): ``clap`` (valid or not: not applied, not checked),
  ``irot``, ``imir``, an unknown property, an essential ``pasp``;
- files cv2 refuses (``refused_*``): no ``meta``, a ``hdlr`` that is not
  ``pict``, an item without ``av1C``, ``pixi`` at another depth than
  ``av1C``, ``colr`` reserved bits, a matrix libavif does not convert, the
  identity matrix over 4:2:0, a cut item, a bad tile trailing bit, an
  unknown property marked essential, ``clap`` or ``a1op`` not marked
  essential, ``a1lx`` marked essential;
- intra block copy (``ibc_*``), which libaom picks for flat or blocky
  content that PIL writes with screen content tools: PIL's 4:2:0 and 4:4:4
  scenes at qualities 30-90 and speeds 2 and 6, 4:0:0, 4:2:2, two tile
  columns, 128 x 128 superblocks, odd sides, a small file whose every cut the tests read, blocky
  repeated tiles whose blocks code split transform trees (depths 1 and 2);
- 4:2:2 (``yuv422_*``, PIL's): pictures and a scene across qualities,
  speeds 0-4 (loop restoration), CDEF turned on (chroma directions
  remapped), odd sides, limited range, screen content (palettes), two tile
  columns;
- the five 480 x 640 files ``chip_smoke.py`` times (cv2's default, cv2 at
  speed 2, PIL 4:4:4 in two tiles, PIL's default of a scene that codes
  intra block copy, PIL 4:2:2);
- ``coco_00.avif`` ... ``coco_31.avif``, the WebP fixtures' 480 x 640
  scenes of two people each, in turn cv2's default, cv2 at speed 2, gray
  (4:0:0), PIL 4:4:4 in two tiles (libaom's intra block copy, which it
  picks for these flat scenes, turned off: ROADMAP A10 part 3, step 6b;
  its palettes stay) and BGRA with its alpha item, whose people
  ``coco_scenes.json`` lists as (cx, cy, ax, ay) ellipses, for the AVIF
  COCO tree of the tests and of ``chip_smoke.py`` (avif480);
- ``pil480_00.avif`` ... ``pil480_31.avif``, the same scenes as PIL writes
  them: the even ones at its defaults (4:2:0, where libaom codes most of
  them with intra block copy), the odd ones in turn in 4:2:2 at its default
  quality and in 4:4:4 in two tiles with intra block copy left on: the
  avif_pil480 COCO tree.

``<name>.npz`` holds what cv2 gives for it, as ``tests/data/webp`` stores
it (``cv2_reads`` there), every array as its SHA-256 and shape.
``tests/test_torch_port_avif.py`` holds the stored arrays against cv2 and
the port; ``chip_smoke.py`` holds the port against them on a machine
without cv2.
"""
import glob
import importlib.util
import io
import json
import os
import struct

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "webp_fixtures", os.path.join(os.path.dirname(HERE), "webp", "make_fixtures.py"))
webp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(webp)
picture, scene, cv2_reads, matches = webp.picture, webp.scene, webp.cv2_reads, webp.matches
webp.BIG = 0  # every decode is stored as its SHA-256: the set stays small

#: the files chip_smoke.py times, 480 x 640
TIMED = ("cv2_480x640.avif", "cv2_s2_480x640.avif", "pil444_tiles_480x640.avif", "pil480_00.avif",
         "pil422_480x640.avif")
#: the COCO scenes: count, size
COCO_SCENES, COCO_HW = 32, (480, 640)
#: the forms of the COCO scenes, in turn
COCO_FORMS = ("cv2", "cv2_s2", "gray", "pil444_tiles", "bgra")
#: the forms of the PIL scenes (avif_pil480), in turn
PIL_FORMS = ("pil", "pil422", "pil", "pil444_tiles_ibc")
#: the COCO trees: name -> fixture prefix
TREES = {"avif480": "coco_", "avif_pil480": "pil480_"}
#: libaom options of PIL's files: name -> ``advanced``
ADVANCED = {
    "cdef_off": {"enable-cdef": "0"},
    "restoration_on": {"enable-restoration": "1"},
    "filter_intra_off": {"enable-filter-intra": "0"},
    "cfl_off": {"enable-cfl-intra": "0"},
    "smooth_paeth_off": {"enable-smooth-intra": "0", "enable-paeth-intra": "0"},
    "angle_delta_off": {"enable-angle-delta": "0"},
    "edge_filter_off": {"enable-intra-edge-filter": "0"},
    "tx64_off": {"enable-tx64": "0"},
    "rect_tx_off": {"enable-rect-tx": "0"},
    "reduced_tx_set": {"reduced-tx-type-set": "1"},
    "qm_0_3": {"enable-qm": "1", "qm-min": "0", "qm-max": "3"},
    "qm_4_8": {"enable-qm": "1", "qm-min": "4", "qm-max": "8"},
    "qm_9_15": {"enable-qm": "1", "qm-min": "9", "qm-max": "15"},
    "deltaq_1": {"deltaq-mode": "1"},
    "deltaq_3": {"deltaq-mode": "3"},
    "chroma_deltaq": {"enable-chroma-deltaq": "1"},
    "sharpness_2": {"sharpness": "2"},
    "sharpness_7": {"sharpness": "7"},
    "sb128": {"sb-size": "128"},
    "ab_4way_partitions": {"enable-ab-partitions": "1", "enable-1to4-partitions": "1"},
    "rect_partitions_off": {"enable-rect-partitions": "0"},
    "aq_3": {"aq-mode": "3"},
}


def screen(h: int, w: int, seed: int) -> np.ndarray:
    """Flat rectangles on a flat ground: libaom codes it as screen content
    (palettes)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    for _ in range(12):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + rng.integers(4, 30), x0:x0 + rng.integers(4, 30)] = rng.integers(0, 256, 3)
    return img


def blocky_tiles(seed: int, tile: int, n: int) -> np.ndarray:
    """A tile of 8 x 8 squares in four colours repeated n x n times, with one
    2 x 2 speck per copy: libaom copies the tiles by intra block copy and
    codes the specks' residual in split transform trees."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (4, 3))
    t = pal[rng.integers(0, 4, (tile // 8, tile // 8))].astype(np.uint8).repeat(8, 0).repeat(8, 1)
    img = np.tile(t, (n, n, 1))
    for _ in range(n * n):
        y, x = rng.integers(0, tile * n - 4, 2)
        img[y:y + 2, x:x + 2] = pal[rng.integers(0, 4)]
    return img


def cv2_avif(img: np.ndarray, *params) -> bytes:
    """cv2's file of an RGB(A) or gray image."""
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    ok, buf = cv2.imencode(".avif", np.ascontiguousarray(img), list(params))
    assert ok
    return buf.tobytes()


def pil_avif(img: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="AVIF", **kwargs)
    return buf.getvalue()


def boxes(data: bytes, start: int = 0, end: int = None, path: str = "") -> dict:
    """{box path: (offset, size)} of the boxes libavif reads."""
    out = {}
    end = len(data) if end is None else end
    o = start
    while o + 8 <= end:
        size, kind = struct.unpack(">I4s", data[o:o + 8])
        size = size or end - o
        name = path + "/" + kind.decode("latin1")
        out.setdefault(name, (o, size))
        skip = {"meta": 4, "iprp": 0, "ipco": 0}.get(kind.decode("latin1"))
        if skip is not None:
            out.update(boxes(data, o + 8 + skip, o + size, name))
        o += size
    return out


def edit(data: bytes, box: str, offset: int, value: bytes) -> bytes:
    """``data`` with ``value`` written ``offset`` bytes into ``box``."""
    o, _ = boxes(data)[box]
    out = bytearray(data)
    out[o + offset:o + offset + len(value)] = value
    return bytes(out)


def add_property(data: bytes, prop: bytes, essential: bool) -> bytes:
    """cv2's file with the property box ``prop`` appended to ``ipco`` and
    associated with item 1 (the sizes of ``meta``, ``iprp``, ``ipco`` and
    ``ipma`` and ``iloc``'s offsets moved to match)."""
    b = boxes(data)
    (meta, _), (iprp, _), (ipco, ipco_size) = (b["/meta"], b["/meta/iprp"],
                                               b["/meta/iprp/ipco"])
    ipma, iloc = b["/meta/iprp/ipma"][0], b["/meta/iloc"][0]
    o, count = ipco + 8, 0
    while o < ipco + ipco_size:
        count, o = count + 1, o + struct.unpack(">I", data[o:o + 4])[0]
    assert data[ipma + 8:ipma + 12] == b"\0\0\0\0" and data[iloc + 8] == 0
    o = ipma + 16
    for _ in range(struct.unpack(">I", data[ipma + 12:ipma + 16])[0]):
        item, n = struct.unpack(">HB", data[o:o + 3])
        if item == 1:
            count_at, insert_at = o + 2, o + 3 + n
        o += 3 + n
    delta = len(prop) + 1
    out = bytearray(data)
    out[insert_at:insert_at] = bytes([(0x80 if essential else 0) | (count + 1)])
    out[count_at] += 1
    out[ipco + ipco_size:ipco + ipco_size] = prop
    for at, extra in ((meta, delta), (iprp, delta), (ipco, len(prop)), (ipma + len(prop), 1)):
        out[at:at + 4] = struct.pack(">I", struct.unpack(">I", out[at:at + 4])[0] + extra)
    len_size = data[iloc + 12] & 15
    assert data[iloc + 12] >> 4 == 4 and data[iloc + 13] >> 4 == 0
    o = iloc + 16
    for _ in range(struct.unpack(">H", data[iloc + 14:iloc + 16])[0]):
        n = struct.unpack(">H", out[o + 4:o + 6])[0]
        o += 6
        for _ in range(n):
            out[o:o + 4] = struct.pack(">I", struct.unpack(">I", out[o:o + 4])[0] + delta)
            o += 4 + len_size
    return bytes(out)


def prop_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def nclx(data: bytes, mc: int, full: bool, cp: int = 1) -> bytes:
    o, _ = boxes(data)["/meta/iprp/ipco/colr"]
    out = bytearray(data)
    out[o + 12:o + 19] = struct.pack(">HHHB", cp, 13, mc, 0x80 if full else 0)
    return bytes(out)


def small_forms() -> dict:
    img = picture(48, 64, 1, noise=6)
    gray = picture(40, 56, 2, noise=6)[..., 1]
    rgba = np.dstack([picture(48, 64, 3, noise=4),
                      np.tile(np.linspace(0, 255, 64).astype(np.uint8), (48, 1))])
    out = {}
    for q in range(0, 101, 10):
        out[f"cv2_q{q:03d}"] = cv2_avif(img, cv2.IMWRITE_AVIF_QUALITY, q)
    for s in range(11):
        out[f"cv2_s{s:02d}"] = cv2_avif(picture(72, 96, 10 + s, noise=8),
                                        cv2.IMWRITE_AVIF_QUALITY, 75, cv2.IMWRITE_AVIF_SPEED, s)
    for q in (30, 75, 100):
        out[f"cv2_gray_q{q:03d}"] = cv2_avif(gray, cv2.IMWRITE_AVIF_QUALITY, q)
    for q in (50, 90, 100):
        out[f"cv2_bgra_q{q:03d}"] = cv2_avif(rgba, cv2.IMWRITE_AVIF_QUALITY, q)
    for h, w in ((1, 1), (2, 3), (7, 13), (13, 7), (17, 23), (65, 129), (129, 65)):
        out[f"cv2_{h}x{w}"] = cv2_avif(picture(h, w, h + w, noise=6))
    out["cv2_lossless_7x13"] = cv2_avif(picture(7, 13, 5), cv2.IMWRITE_AVIF_QUALITY, 100)
    out["cv2_lossless_33x65"] = cv2_avif(picture(33, 65, 6, noise=3), cv2.IMWRITE_AVIF_QUALITY, 100)
    out["cv2_192x256_q40_s6"] = cv2_avif(picture(192, 256, 7, noise=10), cv2.IMWRITE_AVIF_QUALITY,
                                         40, cv2.IMWRITE_AVIF_SPEED, 6)
    out["cv2_200x136_s3"] = cv2_avif(picture(200, 136, 8, noise=12), cv2.IMWRITE_AVIF_SPEED, 3)

    for seed in range(3):
        out[f"cv2_screen_s2_{seed}"] = cv2_avif(screen(64, 96, seed), cv2.IMWRITE_AVIF_SPEED, 2)
        out[f"pil_screen_444_{seed}"] = pil_avif(screen(80, 72, 10 + seed), quality=70,
                                                 subsampling="4:4:4")

    base = picture(96, 128, 20, noise=8)
    out["pil_444_q60"] = pil_avif(base, quality=60, subsampling="4:4:4")
    out["pil_444_q90"] = pil_avif(base, quality=90, subsampling="4:4:4", speed=4)
    out["pil_400_q50"] = pil_avif(base, quality=50, subsampling="4:0:0")
    out["pil_400_q95"] = pil_avif(base, quality=95, subsampling="4:0:0", speed=3)
    out["pil_420_limited"] = pil_avif(base, quality=70, range="limited")
    out["pil_444_limited"] = pil_avif(base, quality=70, range="limited", subsampling="4:4:4")
    out["pil_lossless_444"] = pil_avif(picture(40, 48, 21, noise=4), quality=100,
                                       subsampling="4:4:4")
    wide = picture(128, 640, 22, noise=6)
    out["pil_tiles_cols2"] = pil_avif(wide, quality=60, tile_cols=1)
    out["pil_tiles_2x2"] = pil_avif(picture(256, 256, 23, noise=6), quality=50, tile_cols=1,
                                    tile_rows=1, speed=7)
    out["pil_tiles_444_rows4"] = pil_avif(picture(288, 96, 24, noise=6), quality=55, tile_rows=2,
                                          subsampling="4:4:4")
    for name, adv in ADVANCED.items():
        out[f"pil_adv_{name}"] = pil_avif(base, quality=55, speed=5, advanced=adv)
    rgb = Image.fromarray(base)
    for o in (2, 3, 6):
        exif = Image.Exif()
        exif[0x0112] = o
        buf = io.BytesIO()
        rgb.save(buf, format="AVIF", quality=70, exif=exif.tobytes())
        out[f"pil_orientation_{o}"] = buf.getvalue()
    exif = Image.Exif()
    exif[0x010F] = "avif fixture"
    buf = io.BytesIO()
    rgb.save(buf, format="AVIF", quality=70, exif=exif.tobytes())
    out["pil_exif_item"] = buf.getvalue()
    # an EXIF item that keeps an orientation (PIL moves it to irot / imir):
    # its ResolutionUnit entry (SHORT 3) turned into Orientation 6
    exif = Image.Exif()
    exif[0x0128] = 3
    buf = io.BytesIO()
    rgb.save(buf, format="AVIF", quality=70, exif=exif.tobytes())
    data = bytearray(buf.getvalue())
    entry = data.index(b"\x01\x28\x00\x03\x00\x00\x00\x01\x00\x03")
    data[entry:entry + 2] = b"\x01\x12"
    data[entry + 8:entry + 10] = b"\x00\x06"
    out["pil_exif_orientation_6"] = bytes(data)
    buf = io.BytesIO()
    rgb.save(buf, format="AVIF", quality=70, icc_profile=b"\0" * 128)
    out["pil_icc"] = buf.getvalue()
    buf = io.BytesIO()
    rgb.save(buf, format="AVIF", quality=70, xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    out["pil_xmp"] = buf.getvalue()

    cv2_file = cv2_avif(picture(40, 64, 30, noise=6), cv2.IMWRITE_AVIF_QUALITY, 80)
    for mc, full, cp in ((1, True, 1), (1, False, 1), (9, True, 9), (9, False, 9), (6, False, 1),
                         (12, True, 9), (12, False, 2), (2, True, 2)):
        out[f"nclx_mc{mc:02d}_cp{cp:02d}_{'full' if full else 'limited'}"] = nclx(cv2_file, mc,
                                                                                 full, cp)

    clap = prop_box(b"clap", struct.pack(">8I", 32, 1, 20, 1, 0, 1, 0, 1))
    out["prop_clap"] = add_property(cv2_file, clap, True)
    out["prop_clap_invalid"] = add_property(
        cv2_file, prop_box(b"clap", struct.pack(">8I", 63, 2, 80, 1, 5, 1, 3, 0)), True)
    out["prop_irot"] = add_property(cv2_file, prop_box(b"irot", b"\x01"), True)
    out["prop_imir"] = add_property(cv2_file, prop_box(b"imir", b"\x01"), True)
    out["prop_unknown"] = add_property(cv2_file, prop_box(b"xyzw", bytes(4)), False)
    out["prop_pasp_essential"] = add_property(cv2_file, prop_box(b"pasp", struct.pack(">II", 2, 1)),
                                              True)
    out["refused_prop_unknown_essential"] = add_property(cv2_file, prop_box(b"xyzw", bytes(4)), True)
    out["refused_prop_clap_not_essential"] = add_property(cv2_file, clap, False)
    out["refused_prop_a1lx_essential"] = add_property(cv2_file, prop_box(b"a1lx", bytes(7)), True)
    out["refused_prop_a1op_not_essential"] = add_property(cv2_file, prop_box(b"a1op", b"\0"), False)

    out["refused_no_meta"] = cv2_file[:boxes(cv2_file)["/meta"][0]] + \
        cv2_file[sum(boxes(cv2_file)["/meta"]):]
    out["refused_hdlr_not_pict"] = edit(cv2_file, "/meta/hdlr", 16, b"pixx")
    out["refused_no_av1c"] = edit(cv2_file, "/meta/iprp/ipco/av1C", 4, b"xv1C")
    out["refused_pixi_depth"] = edit(cv2_file, "/meta/iprp/ipco/pixi", 13, b"\x0a\x0a\x0a")
    out["refused_colr_reserved"] = edit(cv2_file, "/meta/iprp/ipco/colr", 18, b"\x81")
    out["refused_matrix_3"] = nclx(cv2_file, 3, True)
    out["refused_identity_420"] = nclx(cv2_file, 0, True)
    mdat = boxes(cv2_file)["/mdat"]
    out["refused_cut_item"] = cv2_file[:mdat[0] + mdat[1] - 9]
    last = bytearray(cv2_file)
    last[-1] ^= 0x01  # the tile's last byte: its trailing bits no longer hold
    out["refused_tile_trailing_bits"] = bytes(last)
    return out


def intrabc_forms() -> dict:
    """Files libaom codes with intra block copy (each checked to use it by
    the tests' coverage test)."""
    sc = scene(2)[0]
    out = {}
    for q, sp in ((50, 2), (70, 6), (90, 2)):
        out[f"ibc_420_q{q}_s{sp}"] = pil_avif(sc, quality=q, speed=sp)
    for q, sp in ((30, 2), (50, 2), (50, 6), (70, 6)):
        out[f"ibc_444_q{q}_s{sp}"] = pil_avif(sc, quality=q, speed=sp, subsampling="4:4:4")
    out["ibc_400"] = pil_avif(sc, quality=60, subsampling="4:0:0")
    out["ibc_422_q75_s6"] = pil_avif(sc, quality=75, speed=6, subsampling="4:2:2")
    out["ibc_420_tiles"] = pil_avif(sc, quality=60, tile_cols=1)
    out["ibc_444_sb128"] = pil_avif(sc, quality=60, speed=6, subsampling="4:4:4",
                                    advanced={"sb-size": "128"})
    # libaom codes this flat scene with intra block copy in 4:4:4 in two tiles
    out["ibc_444_tiles"] = pil_avif(scene(8)[0], quality=60, subsampling="4:4:4", tile_cols=1)
    odd = np.ascontiguousarray(sc[:237, :331])
    out["ibc_420_237x331"] = pil_avif(odd)
    out["ibc_444_237x331"] = pil_avif(odd, subsampling="4:4:4")
    out["ibc_422_239x317"] = pil_avif(np.ascontiguousarray(sc[:239, :317]), quality=75, speed=6,
                                      subsampling="4:2:2")
    out["ibc_444_small"] = pil_avif(np.ascontiguousarray(scene(1)[0][:240, :320]), subsampling="4:4:4")
    out["ibc_vartx_64"] = pil_avif(blocky_tiles(2, 64, 8), quality=60, speed=0)
    out["ibc_vartx_32"] = pil_avif(blocky_tiles(1, 32, 16), quality=60, speed=0)
    return out


def yuv422_forms() -> dict:
    """PIL's 4:2:2 files."""
    out = {}
    pic = picture(96, 128, 5, noise=8)
    for q in (30, 60, 90):
        out[f"yuv422_q{q}"] = pil_avif(pic, quality=q, subsampling="4:2:2")
    for q in (40, 75):
        out[f"yuv422_scene_q{q}"] = pil_avif(scene(7)[0], quality=q, subsampling="4:2:2")
    for sp in range(5):
        out[f"yuv422_s{sp}"] = pil_avif(picture(72, 96, 10 + sp, noise=8), speed=sp, subsampling="4:2:2")
    out["yuv422_scene_s0"] = pil_avif(scene(3)[0], quality=60, speed=0, subsampling="4:2:2")
    out["yuv422_cdef"] = pil_avif(scene(1)[0], quality=50, speed=0, subsampling="4:2:2",
                                  advanced={"enable-cdef": "1"})
    out["yuv422_cdef_picture"] = pil_avif(picture(128, 160, 3, noise=8), quality=50, speed=1,
                                          subsampling="4:2:2", advanced={"enable-cdef": "1"})
    out["yuv422_24x32"] = pil_avif(picture(24, 32, 4), subsampling="4:2:2")
    out["yuv422_37x53"] = pil_avif(picture(37, 53, 3, noise=8), subsampling="4:2:2")
    out["yuv422_limited"] = pil_avif(picture(96, 128, 6, noise=8), quality=60, subsampling="4:2:2",
                                     range="limited")
    out["yuv422_screen"] = pil_avif(screen(80, 72, 4), quality=70, subsampling="4:2:2")
    out["yuv422_tiles"] = pil_avif(picture(128, 640, 6, noise=8), quality=60, subsampling="4:2:2",
                                   tile_cols=1)
    return out


def coco_file(i: int, img: np.ndarray) -> bytes:
    form = COCO_FORMS[i % len(COCO_FORMS)]
    if form == "cv2":
        return cv2_avif(img)
    if form == "cv2_s2":
        return cv2_avif(img, cv2.IMWRITE_AVIF_SPEED, 2)
    if form == "gray":
        return cv2_avif(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    if form == "pil444_tiles":
        # libaom takes these flat scenes for screen content: intra block
        # copy (step 6b) is turned off, its palettes stay
        return pil_avif(img, quality=60, subsampling="4:4:4", tile_cols=1,
                        advanced={"enable-intrabc": "0"})
    alpha = np.full(img.shape[:2], 255, np.uint8)
    alpha[:, :40] = 0
    return cv2_avif(np.dstack([img, alpha]))


def pil_file(i: int, img: np.ndarray) -> bytes:
    form = PIL_FORMS[i % len(PIL_FORMS)]
    if form == "pil":
        return pil_avif(img)
    if form == "pil422":
        return pil_avif(img, subsampling="4:2:2")
    return pil_avif(img, quality=60, subsampling="4:4:4", tile_cols=1)


def fixtures() -> dict:
    out = small_forms()
    out.update(intrabc_forms())
    out.update(yuv422_forms())
    big = picture(480, 640, 40)
    out["cv2_480x640"] = cv2_avif(big)
    out["cv2_s2_480x640"] = cv2_avif(big, cv2.IMWRITE_AVIF_SPEED, 2)
    out["pil444_tiles_480x640"] = pil_avif(big, quality=60, subsampling="4:4:4", tile_cols=1)
    out["pil422_480x640"] = pil_avif(big, subsampling="4:2:2")
    scenes = []
    for i in range(COCO_SCENES):
        img, people = scene(i)
        out[f"coco_{i:02d}"] = coco_file(i, img)
        out[f"pil480_{i:02d}"] = pil_file(i, img)
        scenes.append(people)
    with open(os.path.join(HERE, "coco_scenes.json"), "w") as f:
        json.dump({"height": COCO_HW[0], "width": COCO_HW[1], "people": scenes}, f)
    return out


def main() -> None:
    for old in glob.glob(os.path.join(HERE, "*.avif")) + glob.glob(os.path.join(HERE, "*.npz")):
        os.remove(old)
    total = 0
    for name, data in fixtures().items():
        path = os.path.join(HERE, name + ".avif")
        with open(path, "wb") as f:
            f.write(data)
        arrays = cv2_reads(path, data)
        if name.startswith("refused_"):
            assert sorted(arrays) == ["decode_same"], name  # cv2 returns None
        else:
            assert "color" in arrays or "color_sha256" in arrays, name
        if name.startswith(tuple(TREES.values())):
            assert len(data) <= 60_000, (name, len(data))
        np.savez_compressed(os.path.join(HERE, name + ".npz"), **arrays)
        total += len(data) + os.path.getsize(os.path.join(HERE, name + ".npz"))
        print(f"{name}: {len(data)} bytes, {sorted(arrays)}")
    print(f"{total} bytes in all")


if __name__ == "__main__":
    main()

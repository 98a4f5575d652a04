"""Write the JPEG 2000 fixtures of the port's JPEG 2000 decoder, with cv2's
decodes beside them.

    python tests/data/jpeg2000/make_fixtures.py

Each ``<name>.jp2`` (a JP2 file or a raw codestream, whichever its leading
bytes say) is written by ``cv2.imencode``, PIL or ``j2k_writer.c`` (the
tests' writer of the settings neither exposes, built with gcc against the
system's OpenJPEG; it must first write PIL's bytes for PIL's settings,
``Writer.check_against_pil``), or assembled from their codestreams and
hand-made boxes, from seeded pixels:

- cv2's own files (5/3, one layer, by rate), gray and colour, odd sides;
- PIL's: 5/3 lossless with and without RCT, 9/7 with ICT lossless and by
  rate, gray, gray + alpha, RGBA, 16-bit gray, raw codestreams, every
  progression order, tiles, layers, code-block and precinct sizes, PLT,
  one resolution;
- the writer's: each code-block style (BYPASS, RESET, TERMALL, VSC, PTERM,
  SEGSYM and all together), ROI, SOP / EPH, POC, tile-parts, TLM, 10- and
  12-bit samples; and its SOP / EPH files with their packet headers moved
  by hand into PPT or PPM markers (``packed_headers``);
- hand-made boxes: ``colr`` gray, sYCC and ICC, ``pclr`` + ``cmap``,
  ``cdef`` reordering the channels, a trailing box;
- COD's multiple component transform over components that a COC gives
  the other wavelet (``mct_mixed_*``);
- files cv2 refuses (``refused_*``): a signed component, 4-bit samples,
  subsampled components, an image offset (also one past a POC's last
  level), an incomplete ``cdef``, a cut codestream;
- the three 480 x 640 files ``chip_smoke.py`` times (cv2's default, PIL 5/3
  with RCT, PIL 9/7 with ICT);
- ``coco_00.jp2`` ... ``coco_31.jp2``, 480 x 640 scenes of two people each,
  in turn cv2's default, PIL 5/3 lossless, 9/7 by rate, 256 x 256 tiles,
  RPCL with precincts and three layers, whose people ``coco_scenes.json``
  lists as (cx, cy, ax, ay) ellipses, for the JPEG 2000 COCO tree of the
  tests and of ``chip_smoke.py``.

``<name>.npz`` holds what cv2 gives for it, as ``tests/data/webp`` stores
it (``cv2_reads`` there), every array as its SHA-256 and shape.
``tests/test_torch_port_jpeg2000.py`` holds the stored arrays against cv2
and the port; ``chip_smoke.py`` holds the port against them on a machine
without cv2.
"""
import glob
import importlib.util
import io
import json
import os
import shutil
import struct
import subprocess
import tempfile

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
TIMED = ("cv2_480x640.jp2", "pil53_rct_480x640.jp2", "pil97_ict_480x640.jp2")
#: the COCO scenes: count, size
COCO_SCENES, COCO_HW = 32, (480, 640)
#: the forms of the COCO scenes, in turn
COCO_FORMS = ("cv2", "pil53", "pil97", "tiled", "rpcl", "layers")


def cv2_jp2(rgb: np.ndarray) -> bytes:
    """``cv2.imencode(".jp2")`` of RGB (or gray) ``rgb``."""
    src = rgb[..., ::-1] if rgb.ndim == 3 else rgb
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(src))
    assert ok
    return buf.tobytes()


def pil_j2k(img: np.ndarray, **kwargs) -> bytes:
    """PIL's JPEG 2000 save (``no_jp2=True``: a raw codestream) of uint8
    L, LA, RGB or RGBA, or uint16 I;16."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG2000", **kwargs)
    return buf.getvalue()


class Writer:
    """``j2k_writer.c``, built with gcc against the system's OpenJPEG."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.exe = os.path.join(tmp, "j2k_writer")
        subprocess.run(["gcc", "-O2", os.path.join(HERE, "j2k_writer.c"), "-l:libopenjp2.so.7",
                        "-o", self.exe], check=True)

    def __call__(self, img: np.ndarray, **settings) -> bytes:
        raw, out = os.path.join(self.tmp, "in.raw"), os.path.join(self.tmp, "out.j2k")
        np.ascontiguousarray(img).tofile(raw)
        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        subprocess.run([self.exe, raw, str(w), str(h), str(c), out]
                       + [f"{k}={v}" for k, v in settings.items()], check=True,
                       capture_output=True)
        with open(out, "rb") as f:
            return f.read()

    def check_against_pil(self) -> int:
        """The writer's bytes equal PIL's for the settings both take (but for
        the OpenJPEG version in the COM marker): the declarations of
        ``j2k_writer.c`` hold.  Returns the number of settings checked."""
        img = picture(37, 45, 2, noise=20)
        cases = (({}, {}), ({"no_jp2": False}, {"jp2": 1}), ({"irreversible": True},
                                                              {"irreversible": 1}),
                 ({"tile_size": (16, 24)}, {"tile": "16x24"}),
                 ({"progression": "RPCL"}, {"prog": "RPCL"}),
                 ({"codeblock_size": (16, 8)}, {"cblk": "16x8"}),
                 ({"precinct_size": (64, 32)}, {"prc": "64x32"}),
                 ({"quality_mode": "rates", "quality_layers": [40, 10, 2]}, {"rates": "40,10,2"}),
                 ({"num_resolutions": 3}, {"numres": 3}), ({"mct": 0}, {"mct": 0}),
                 ({"plt": True}, {"plt": 1}))
        for pil_kw, kw in cases:
            pil_kw = {"no_jp2": True, **pil_kw}
            a, b = pil_j2k(img, **pil_kw), self(img, **kw)
            assert strip_version(a) == strip_version(b), (pil_kw, kw)
        assert strip_version(pil_j2k(img[..., 0].copy(), no_jp2=True)) == \
            strip_version(self(img[..., 0].copy()))
        return len(cases) + 1


def strip_version(data: bytes) -> bytes:
    """``data`` with OpenJPEG's version in its COM marker blanked."""
    i = data.find(b"by OpenJPEG version ")
    if i < 0:
        return data
    j = i + len(b"by OpenJPEG version ")
    k = j
    while k < len(data) and data[k] != 0xFF:
        k += 1
    return data[:j] + b"#" * (k - j) + data[k:]


def box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def jp2(codestream: bytes, h: int, w: int, nc: int, colr=16, boxes=(), bpc: int = 7,
        header_boxes=None, trailing=()) -> bytes:
    """A JP2 file around ``codestream``: signature, ``ftyp``, ``jp2h``
    (``ihdr``, ``colr`` with enumerated space ``colr`` unless None, then
    ``boxes``), ``jp2c``, then ``trailing`` boxes."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    inner = [ihdr] + ([box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", colr))]
                      if colr is not None else []) + list(boxes)
    if header_boxes is not None:
        inner = list(header_boxes)
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
            + box(b"jp2h", b"".join(inner)) + box(b"jp2c", codestream) + b"".join(trailing))


def cdef(entries) -> bytes:
    return box(b"cdef", struct.pack(">H", len(entries))
               + b"".join(struct.pack(">HHH", *e) for e in entries))


def pclr_cmap(palette: np.ndarray, sizes=None) -> list:
    """``pclr`` of ``palette`` [entries, channels] (8 bits, or ``sizes`` bits
    a channel) and the ``cmap`` mapping component 0 through every column."""
    n, c = palette.shape
    sizes = sizes or [8] * c
    body = struct.pack(">HB", n, c) + bytes(s - 1 for s in sizes)
    for row in palette:
        for v, s in zip(row, sizes):
            body += int(v).to_bytes((s + 7) // 8, "big")
    cmap = box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i) for i in range(c)))
    return [box(b"pclr", body), cmap]


def packed_headers(cs: bytes, kind: str, markers: int = 1, order=None) -> bytes:
    """``cs`` (written with SOP and EPH, which mark where each packet's
    header starts and ends) with its packet headers moved into PPT markers
    (``kind="ppt"``: each tile-part's own, split into ``markers`` markers)
    or PPM markers (``"ppm"``: every tile-part's, each after its 4-byte
    Nppm, the whole split into ``markers`` markers), the markers written in
    Zppt / Zppm ``order``; the packets keep their SOP and bodies."""
    main_end = pos = cs.index(b"\xff\x90")
    parts, heads_of = [], []
    while cs[pos:pos + 2] == b"\xff\x90":
        end = pos + struct.unpack(">I", cs[pos + 6:pos + 10])[0]
        sod = cs.index(b"\xff\x93", pos) + 2
        heads, rest, i = b"", b"", sod
        while i < end:
            eph = cs.index(b"\xff\x92", i + 6) + 2
            nxt = cs.find(b"\xff\x91", eph, end)
            nxt = end if nxt < 0 else nxt
            heads, rest, i = heads + cs[i + 6:eph], rest + cs[i:i + 6] + cs[eph:nxt], nxt
        parts.append((cs[pos:sod - 2], rest))
        heads_of.append(heads)
        pos = end

    def split(code: bytes, data: bytes) -> bytes:
        chunks = [data[k * len(data) // markers:(k + 1) * len(data) // markers]
                  for k in range(markers)]
        return b"".join(code + struct.pack(">H", 3 + len(chunks[z])) + bytes([z]) + chunks[z]
                        for z in (order or range(markers)))

    out = cs[:main_end]
    if kind == "ppm":
        out += split(b"\xff\x60", b"".join(struct.pack(">I", len(h)) + h for h in heads_of))
    for (head, rest), heads in zip(parts, heads_of):
        part = head + (split(b"\xff\x61", heads) if kind == "ppt" else b"") + b"\xff\x93" + rest
        out += part[:6] + struct.pack(">I", len(part)) + part[10:]
    return out + cs[pos:]


def flip_transform(cs: bytes, comps) -> bytes:
    """Raw codestream ``cs`` with a COC before its QCD for each component of
    ``comps``: COD's coding style with the other wavelet (5/3 for 9/7 or
    the reverse), so that COD's MCT runs over components of both kinds."""
    pos, found = 2, {}
    while cs[pos:pos + 2] != b"\xff\x90":
        found[cs[pos:pos + 2]] = pos
        pos += 2 + struct.unpack(">H", cs[pos + 2:pos + 4])[0]
    cod, qcd = found[b"\xff\x52"], found[b"\xff\x5c"]
    spcod = cs[cod + 9:cod + 14]  # levels, code-block sides, style, transform
    sp = spcod[:4] + bytes([1 - spcod[4]])
    cocs = b"".join(b"\xff\x53" + struct.pack(">H", 4 + len(sp)) + bytes([c, 0]) + sp
                    for c in comps)
    return cs[:qcd] + cocs + cs[qcd:]


def small_forms(writer: Writer) -> dict:
    """{name: thunk giving the file} of the small forms, written live by the
    tests and committed (a part of them) by ``fixtures``."""
    img = picture(45, 53, 31, noise=3)
    gray = img[..., 1].copy()
    rgba = np.dstack([img, picture(45, 53, 32)[..., 0]])
    out = {
        "cv2_rgb": lambda: cv2_jp2(picture(64, 80, 33, noise=8)),
        "cv2_gray": lambda: cv2_jp2(picture(40, 36, 34)[..., 0].copy()),
        "cv2_33x45": lambda: cv2_jp2(picture(33, 45, 35, noise=30)),
        "pil53_rgb": lambda: pil_j2k(img),
        "pil53_mct0": lambda: pil_j2k(img, mct=0),
        "pil53_gray": lambda: pil_j2k(gray),
        "pil53_la": lambda: pil_j2k(np.dstack([gray, rgba[..., 3]])),
        "pil53_rgba": lambda: pil_j2k(rgba),
        "pil53_gray16": lambda: pil_j2k(gray.astype(np.uint16) * 257 + 33),
        "pil53_raw_rgb": lambda: pil_j2k(img, no_jp2=True),
        "pil53_raw_gray": lambda: pil_j2k(gray, no_jp2=True),
        "pil97_lossless": lambda: pil_j2k(img, irreversible=True),
        "pil97_rate12": lambda: pil_j2k(img, irreversible=True, quality_mode="rates",
                                        quality_layers=[12]),
        "pil97_mct0_rate8": lambda: pil_j2k(img, irreversible=True, mct=0,
                                            quality_mode="rates", quality_layers=[8]),
        "pil97_gray_db": lambda: pil_j2k(gray, irreversible=True, quality_mode="dB",
                                         quality_layers=[38]),
        "pil53_tiles": lambda: pil_j2k(img, tile_size=(16, 24)),
        "pil97_tiles_rate": lambda: pil_j2k(img, tile_size=(32, 20), irreversible=True,
                                            quality_mode="rates", quality_layers=[10]),
        "pil53_layers": lambda: pil_j2k(img, quality_mode="rates", quality_layers=[60, 20, 6]),
        "pil53_cblk4x4": lambda: pil_j2k(img, codeblock_size=(4, 4)),
        "pil53_cblk32x8": lambda: pil_j2k(img, codeblock_size=(32, 8)),
        "pil53_prc32": lambda: pil_j2k(img, precinct_size=(32, 32), codeblock_size=(8, 8)),
        "pil53_plt": lambda: pil_j2k(img, plt=True),
        "pil53_res1": lambda: pil_j2k(img, num_resolutions=1),
        "pil53_res2": lambda: pil_j2k(img, num_resolutions=2),
        "pil53_1x1": lambda: pil_j2k(img[:1, :1].copy()),
        "pil53_1x37": lambda: pil_j2k(img[:1, :37].copy()),
        "pil53_29x1": lambda: pil_j2k(img[:29, :1].copy()),
    }
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"pil_{prog.lower()}"] = lambda prog=prog: pil_j2k(
            img, progression=prog, precinct_size=(32, 32), codeblock_size=(8, 8),
            quality_mode="rates", quality_layers=[40, 12, 3], tile_size=(48, 32))
    for name, bits in (("bypass", 1), ("reset", 2), ("termall", 4), ("vsc", 8),
                       ("pterm", 16), ("segsym", 32), ("all", 63), ("bypass_vsc", 9)):
        out[f"mode_{name}"] = lambda bits=bits: writer(img, mode=bits, rates="30,10,1",
                                                       cblk="16x16")
        out[f"mode_{name}_97"] = lambda bits=bits: writer(img, mode=bits, irreversible=1,
                                                          rates="20,8,2")
    out.update({
        "sop": lambda: writer(img, csty=2),
        "sop_eph_rpcl": lambda: writer(img, csty=6, rates="20,5,1", prc="64x64", cblk="16x16",
                                       prog="RPCL"),
        "roi": lambda: writer(img, roi="0,3"),
        "roi_97": lambda: writer(img, roi="1,5", irreversible=1, rates="10,3"),
        "roi_bypass": lambda: writer(img, roi="0,4", mode=1, rates="10,3"),
        "poc": lambda: writer(img, poc="1:0:0:1:3:3:RLCP/1:3:0:1:6:3:LRCP", rates="10,3"),
        "poc3": lambda: writer(img, poc="1:0:0:2:4:2:CPRL/1:0:2:2:6:3:LRCP/1:4:0:2:6:2:PCRL",
                               rates="10,3"),
        "tileparts_r": lambda: writer(img, tp="R", tile="16x16"),
        "tileparts_l": lambda: writer(img, tp="L", rates="10,3,1"),
        "tileparts_c_cprl": lambda: writer(img, tp="C", tile="32x32", prog="CPRL"),
        "tlm": lambda: writer(img, tlm=1, tp="R", tile="16x16"),
        "prec12": lambda: writer((img.astype(np.uint16) * 16 + 7), prec=12),
        "prec10_gray_97": lambda: writer(gray.astype(np.uint16) * 4 + 1, prec=10,
                                         irreversible=1, rates="6"),
        "prec9_jp2": lambda: writer(img.astype(np.uint16) * 2, prec=9, jp2=1),
        "ppt": lambda: packed_headers(writer(img, csty=6, rates="20,5"), "ppt", 3, [1, 0, 2]),
        "ppm_tiles": lambda: packed_headers(writer(img, csty=6, tile="16x16", tp="R",
                                                   rates="20,5"), "ppm", 3),
        # COD's MCT over components of both wavelets: component 0's picks it
        "mct_mixed_53_c0": lambda: flip_transform(writer(img, rates="20,5"), [0]),
        "mct_mixed_53_c1": lambda: flip_transform(writer(img), [1]),
        "mct_mixed_97_c2": lambda: flip_transform(writer(img, irreversible=1), [2]),
        "mct_mixed_97_c12": lambda: flip_transform(writer(img, irreversible=1, rates="20,5",
                                                          tile="32x32"), [1, 2]),
    })
    cs_rgb = lambda: pil_j2k(img, no_jp2=True, mct=0)  # noqa: E731
    cs_gray = lambda: pil_j2k(gray, no_jp2=True)  # noqa: E731
    palette = np.random.default_rng(36).integers(0, 256, (200, 3))
    index = (picture(45, 53, 37)[..., 0].astype(np.int32) * 220 // 255).astype(np.uint8)
    out.update({
        "box_colr_gray": lambda: jp2(cs_gray(), 45, 53, 1, colr=17),
        "box_colr_sycc": lambda: jp2(cs_rgb(), 45, 53, 3, colr=18),
        "box_colr_cielab": lambda: jp2(cs_rgb(), 45, 53, 3, colr=14),
        "box_no_colr": lambda: jp2(cs_rgb(), 45, 53, 3, colr=None),
        "box_icc": lambda: jp2(cs_rgb(), 45, 53, 3, colr=None,
                               boxes=[box(b"colr", bytes([2, 0, 0]) + b"an ICC profile")]),
        "box_two_colr": lambda: jp2(cs_rgb(), 45, 53, 3, colr=18,
                                    boxes=[box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 16))]),
        "box_pclr": lambda: jp2(pil_j2k(index, no_jp2=True), 45, 53, 1,
                                boxes=pclr_cmap(palette)),
        "box_pclr_12bit": lambda: jp2(pil_j2k(index, no_jp2=True), 45, 53, 1,
                                      boxes=pclr_cmap(palette * 16 + 5, [12, 12, 12])),
        "box_pclr_no_cmap": lambda: jp2(pil_j2k(index, no_jp2=True), 45, 53, 1,
                                        boxes=pclr_cmap(palette)[:1]),
        "box_cdef_swap": lambda: jp2(cs_rgb(), 45, 53, 3,
                                     boxes=[cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])]),
        "box_cdef_alpha": lambda: jp2(cs_rgb(), 45, 53, 3,
                                      boxes=[cdef([(0, 1, 0), (1, 0, 2), (2, 0, 3)])]),
        "box_trailing": lambda: jp2(cs_rgb(), 45, 53, 3, trailing=[box(b"xml ", b"<a/>")]),
        "box_ihdr_twice": lambda: jp2(cs_rgb(), 45, 53, 3, boxes=[
            box(b"ihdr", struct.pack(">IIHBBBB", 9, 9, 1, 7, 7, 0, 0))]),
        "refused_signed": lambda: pil_j2k(img, no_jp2=True, signed=True),
        "refused_prec4": lambda: writer(img // 16, prec=4),
        "refused_subsampled": lambda: writer(img, sub="2x2", mct=0),
        "refused_offset": lambda: writer(img, offset="3x5"),
        # a POC stops short of the top level, whose area then misses the
        # offset component's: OpenJPEG fails the decode
        "refused_offset_poc": lambda: writer(img, offset="64x64", poc="1:0:0:1:3:3:LRCP"),
        "refused_cdef_incomplete": lambda: jp2(cs_rgb(), 45, 53, 3,
                                               boxes=[cdef([(0, 0, 1), (1, 0, 2)])]),
        "refused_ihdr_mismatch": lambda: jp2(cs_rgb(), 44, 53, 3),
        "refused_cut": lambda: pil_j2k(img)[:-40],
        "refused_colr_cmyk": lambda: jp2(cs_rgb(), 45, 53, 3, colr=12),
    })
    return out


def coco_file(i: int, img: np.ndarray) -> bytes:
    form = COCO_FORMS[i % len(COCO_FORMS)]
    if form == "cv2":
        return cv2_jp2(img)
    kwargs = {"pil53": {}, "pil97": dict(irreversible=True, quality_mode="rates",
                                         quality_layers=[24]),
              "tiled": dict(tile_size=(256, 256)),
              "rpcl": dict(progression="RPCL", precinct_size=(128, 128), codeblock_size=(32, 32)),
              "layers": dict(quality_mode="rates", quality_layers=[40, 20, 10])}[form]
    return pil_j2k(img, **kwargs)


def fixtures(writer: Writer) -> dict:
    forms = small_forms(writer)
    out = {name: make() for name, make in forms.items()}
    big = picture(480, 640, 40)
    out["cv2_480x640"] = cv2_jp2(big)
    out["pil53_rct_480x640"] = pil_j2k(big, quality_mode="rates", quality_layers=[16])
    out["pil97_ict_480x640"] = pil_j2k(big, irreversible=True, quality_mode="rates",
                                       quality_layers=[16])
    scenes = []
    for i in range(COCO_SCENES):
        img, people = scene(i)
        out[f"coco_{i:02d}"] = coco_file(i, img)
        scenes.append(people)
    with open(os.path.join(HERE, "coco_scenes.json"), "w") as f:
        json.dump({"height": COCO_HW[0], "width": COCO_HW[1], "people": scenes}, f)
    return out


def main() -> None:
    if shutil.which("gcc") is None:
        raise SystemExit("make_fixtures.py builds j2k_writer.c with gcc")
    with tempfile.TemporaryDirectory() as tmp:
        writer = Writer(tmp)
        print(f"j2k_writer.c writes PIL's bytes for {writer.check_against_pil()} settings")
        for old in glob.glob(os.path.join(HERE, "*.jp2")) + glob.glob(os.path.join(HERE, "*.npz")):
            os.remove(old)
        total = 0
        for name, data in fixtures(writer).items():
            path = os.path.join(HERE, name + ".jp2")
            with open(path, "wb") as f:
                f.write(data)
            arrays = cv2_reads(path, data)
            if name.startswith("refused_"):
                assert sorted(arrays) == ["decode_same"], name  # cv2 returns None
            if name.startswith("coco_"):
                assert len(data) <= 40_000, (name, len(data))
            np.savez_compressed(os.path.join(HERE, name + ".npz"), **arrays)
            total += len(data) + os.path.getsize(os.path.join(HERE, name + ".npz"))
            print(f"{name}: {len(data)} bytes, {sorted(arrays)}")
        print(f"{total} bytes in all")


if __name__ == "__main__":
    main()

"""JPEG 2000 through the port's reader (``core/imread.py`` ->
``core/jpeg2000.py``, the codestream in ``ops/native/jpeg2000.cpp``)
against live ``cv2.imread`` and ``cv2.imdecode`` (the JAX package's
readers; cv2 5.0 with OpenJPEG 2.5.3) in both read modes: every pixel equal
where cv2 decodes, ``FileNotFoundError`` exactly where cv2 returns None,
``ImageSizeError`` where cv2 raises on the size.

- the forms of ``tests/data/jpeg2000/make_fixtures.py``, written live by
  cv2, PIL and ``j2k_writer.c`` (which first writes PIL's bytes for PIL's
  settings): 5/3 and 9/7, RCT and ICT, every progression order, POC, tiles
  and tile-parts, layers, precincts, code-block sizes and styles, ROI,
  SOP / EPH, TLM / PLT, 1 to 16 bits, gray, gray + alpha, RGB(A), raw
  codestreams and JP2 files, hand-made ``colr`` / ``pclr`` / ``cmap`` /
  ``cdef`` boxes, COC / QCC markers and packet headers moved into PPM /
  PPT markers, and files cv2 refuses;
- the JP2 box rules and the codestream's marker rules, on hand-edited
  files;
- every cut of three small files, seeded byte flips of six;
- the forms the port does not decode raise ``UnsupportedImage`` naming
  ROADMAP A10 part 3, step 5;
- the committed fixtures against the decodes stored beside them and live
  cv2;
- a COCO tree of JPEG 2000 images converted by both packages'
  ``transfer_coco`` (file for file equal), read by both datasets, and a few
  port train steps on it; ``.jp2``-named COCO and OCHuman trees, whose mix
  previews are JPEG 2000 files, converted by both packages byte for byte
  (the encoder: ``tests/test_torch_port_jpeg2000_enc.py``), and a
  Supervisely project of ``.jp2`` images, which both re-encode as PNG.
"""
import glob
import importlib.util
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data import converters as jconv
from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import ImageSizeError, UnsupportedImage
from instancesegmentation_tpu_torch.data import converters as tconv
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import draw_augment, host_batch
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.train.config import TrainConfig
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.train.steps import augment_config, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg2000")
_spec = importlib.util.spec_from_file_location("jpeg2000_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)
#: what an unported form's message names
STEP = "A10 part 3, step 5"


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    return mf.Writer(str(tmp_path_factory.mktemp("j2k_writer")))


def _cv2(read):
    """cv2's outcome: RGB (or gray) array, None, or "raises" (a size cv2's
    validateInputImageSize refuses)."""
    try:
        img = read()
    except cv2.error:
        return "raises"
    return None if img is None else img[..., ::-1] if img.ndim == 3 else img


def _port(read):
    try:
        return read()
    except FileNotFoundError:
        return None
    except ImageSizeError:
        return "raises"


def _same(got, want) -> bool:
    if isinstance(got, str) or isinstance(want, str) or got is None or want is None:
        return (got is None and want is None) or (isinstance(got, str) and got == want)
    return got.shape == want.shape and np.array_equal(got, want)


def _against_cv2(tmp_path, data: bytes, file: bool = True) -> dict:
    """The port's reads of ``data`` (as a file and as bytes) equal cv2's in
    both modes; returns cv2's outcome per mode."""
    path = str(tmp_path / "image.jp2")
    with open(path, "wb") as f:
        f.write(data)
    buf = np.frombuffer(data, np.uint8)
    out = {}
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        want = _cv2(lambda: cv2.imdecode(buf, flag))
        assert _same(_port(lambda: imdecode(data, mode)), want), f"imdecode {mode}"
        if file:
            want_file = _cv2(lambda: cv2.imread(path, flag))
            assert _same(_port(lambda: imread(path, mode)), want_file), f"imread {mode}"
        out[mode] = want
    return out


# -- the forms, written here -------------------------------------------------

FORMS = sorted(mf.small_forms(None))


def test_writer_writes_pils_bytes(writer):
    """``j2k_writer.c`` repeats OpenJPEG's declarations: its bytes equal
    PIL's for the settings both take, so its other settings are trusted."""
    assert writer.check_against_pil() >= 12


@pytest.mark.parametrize("name", FORMS)
def test_forms_match_cv2(tmp_path, writer, name):
    data = mf.small_forms(writer)[name]()
    out = _against_cv2(tmp_path, data)
    if name.startswith("refused_"):
        assert out == {"color": None, "gray": None}
    else:  # one component with no colour space reads as gray only ("SRGB is assumed")
        gray_only = name in ("pil53_raw_gray", "prec10_gray_97", "box_pclr_no_cmap")
        assert isinstance(out["gray"], np.ndarray)
        assert (out["color"] is None) == gray_only


# -- hand-edited boxes and markers --------------------------------------------


def _codestream(writer, **settings) -> bytes:
    return writer(mf.picture(21, 27, 41, noise=5), **settings)


def _markers(cs: bytes) -> dict:
    """{marker: offset} of the main header's markers, up to the first SOT."""
    out, pos = {}, 2
    while True:
        m = cs[pos:pos + 2]
        out[m] = pos
        if m == b"\xff\x90":
            return out
        pos += 2 + struct.unpack(">H", cs[pos + 2:pos + 4])[0]


def _box_cases(writer) -> dict:
    box, cs = mf.box, _codestream(writer)
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", 21, 27, 3, 7, 7, 0, 0))
    colr = box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 16))
    sig, ftyp = box(b"jP  ", b"\r\n\x87\n"), box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
    jp2h = box(b"jp2h", ihdr + colr)
    jp2c = box(b"jp2c", cs)
    def xl(typ: bytes, payload: bytes) -> bytes:  # a box with a 64-bit length
        return struct.pack(">I", 1) + typ + struct.pack(">II", 0, 16 + len(payload)) + payload

    return {
        "plain": sig + ftyp + jp2h + jp2c,
        "jp2c_length_0": sig + ftyp + jp2h + struct.pack(">I", 0) + b"jp2c" + cs,
        "jp2c_xl": sig + ftyp + jp2h + xl(b"jp2c", cs),
        "jp2h_xl": sig + ftyp + xl(b"jp2h", ihdr + colr) + jp2c,
        "xl_high_word": sig + ftyp + jp2h + struct.pack(">I", 1) + b"jp2c" + struct.pack(
            ">II", 1, 0) + cs,
        "no_ftyp": sig + jp2h + jp2c,
        "ftyp_odd_size": sig + box(b"ftyp", b"jp2 " + bytes(6)) + jp2h + jp2c,
        "ftyp_short": sig + box(b"ftyp", b"jp2 ") + jp2h + jp2c,
        "no_jp2h": sig + ftyp + jp2c,
        "jp2c_before_jp2h": sig + ftyp + jp2c + jp2h,
        "no_jp2c": sig + ftyp + jp2h,
        "unknown_box_first": sig + ftyp + box(b"uuid", bytes(20)) + jp2h + jp2c,
        "colr_after_jp2h": sig + ftyp + box(b"jp2h", ihdr) + box(
            b"colr", bytes([1, 0, 0]) + struct.pack(">I", 17)) + jp2c,
        "colr_before_jp2h": sig + ftyp + box(b"colr", bytes([1, 0, 0, 0, 0, 0, 17])) + jp2h
        + jp2c,
        "ihdr_short": sig + ftyp + box(b"jp2h", box(b"ihdr", bytes(13)) + colr) + jp2c,
        "ihdr_no_components": sig + ftyp + box(b"jp2h", box(
            b"ihdr", struct.pack(">IIHBBBB", 21, 27, 0, 7, 7, 0, 0)) + colr) + jp2c,
        "no_ihdr": sig + ftyp + box(b"jp2h", colr) + jp2c,
        "jp2h_box_cut": sig + ftyp + box(b"jp2h", ihdr + colr[:-2]) + jp2c,
        "jp2h_tail_short": sig + ftyp + box(b"jp2h", ihdr + colr + b"\x00\x00\x00") + jp2c,
        "colr_meth0": sig + ftyp + box(b"jp2h", ihdr + box(b"colr", bytes([0, 0, 0]))) + jp2c,
        "colr_meth3": sig + ftyp + box(b"jp2h", ihdr + box(b"colr", bytes([3, 0, 0, 1]))) + jp2c,
        "colr_short": sig + ftyp + box(b"jp2h", ihdr + box(b"colr", bytes([1, 0]))) + jp2c,
        "colr_enum_short": sig + ftyp + box(b"jp2h", ihdr + box(b"colr", bytes([1, 0, 0, 0])))
        + jp2c,
        "bpcc_ok": sig + ftyp + box(b"jp2h", ihdr + colr + box(b"bpcc", bytes([7] * 3))) + jp2c,
        "bpcc_wrong_size": sig + ftyp + box(b"jp2h", ihdr + colr + box(b"bpcc", bytes([7] * 2)))
        + jp2c,
        "cmap_without_pclr": sig + ftyp + box(b"jp2h", ihdr + colr + box(b"cmap", bytes(12)))
        + jp2c,
        "pclr_no_entries": sig + ftyp + box(b"jp2h", ihdr + colr + box(
            b"pclr", struct.pack(">HB", 0, 3) + bytes([7, 7, 7]))) + jp2c,
        "pclr_1025_entries": sig + ftyp + box(b"jp2h", ihdr + colr + box(
            b"pclr", struct.pack(">HB", 1025, 1) + bytes([7]) + bytes(1025))) + jp2c,
        "pclr_cut": sig + ftyp + box(b"jp2h", ihdr + colr + box(
            b"pclr", struct.pack(">HB", 4, 3) + bytes([7, 7, 7]) + bytes(10))) + jp2c,
        "cdef_empty": sig + ftyp + box(b"jp2h", ihdr + colr + box(b"cdef", bytes(2))) + jp2c,
        "cdef_twice": sig + ftyp + box(b"jp2h", ihdr + colr + mf.cdef([(0, 0, 1), (1, 0, 2),
                                                                         (2, 0, 3)]) * 2) + jp2c,
        "cdef_bad_channel": sig + ftyp + box(b"jp2h", ihdr + colr + mf.cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3), (5, 0, 1)])) + jp2c,
        "cdef_bad_association": sig + ftyp + box(b"jp2h", ihdr + colr + mf.cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 9)])) + jp2c,
        "cdef_two_alphas": sig + ftyp + box(b"jp2h", ihdr + colr + mf.cdef(
            [(0, 1, 0), (1, 1, 0), (2, 0, 1)])) + jp2c,
        "cdef_rotate": sig + ftyp + box(b"jp2h", ihdr + colr + mf.cdef(
            [(0, 0, 2), (1, 0, 3), (2, 0, 1)])) + jp2c,
        "signature_bad_magic": box(b"jP  ", b"\r\n\x87\n")[:11] + b"\x0b" + ftyp + jp2h + jp2c,
    }


CASES = ("plain", "jp2c_length_0", "jp2c_xl", "jp2h_xl", "xl_high_word", "no_ftyp",
         "ftyp_odd_size", "ftyp_short", "no_jp2h", "jp2c_before_jp2h", "no_jp2c",
         "unknown_box_first", "colr_after_jp2h", "colr_before_jp2h", "ihdr_short",
         "ihdr_no_components", "no_ihdr", "jp2h_box_cut", "jp2h_tail_short", "colr_meth0",
         "colr_meth3", "colr_short", "colr_enum_short", "bpcc_ok", "bpcc_wrong_size",
         "cmap_without_pclr", "pclr_no_entries", "pclr_1025_entries", "pclr_cut", "cdef_empty",
         "cdef_twice", "cdef_bad_channel", "cdef_bad_association", "cdef_two_alphas",
         "cdef_rotate", "signature_bad_magic")


@pytest.mark.parametrize("case", CASES)
def test_box_rules_match_cv2(tmp_path, writer, case):
    _against_cv2(tmp_path, _box_cases(writer)[case])


def _marker_cases(writer) -> dict:
    cs = _codestream(writer)
    m = _markers(cs)
    siz, cod, qcd = m[b"\xff\x51"], m[b"\xff\x52"], m[b"\xff\x5c"]
    sot = m[b"\xff\x90"]

    def put(data: bytes, at: int, value: bytes) -> bytes:
        return data[:at] + value + data[at + len(value):]

    def insert(data: bytes, at: int, seg: bytes) -> bytes:
        return data[:at] + seg + data[at:]

    com = b"\xff\x64" + struct.pack(">H", 6) + b"\x00\x01hi"
    tiled = _codestream(writer, tile="16x16")
    tm = _markers(tiled)
    sots = [i for i in range(len(tiled) - 1) if tiled[i:i + 2] == b"\xff\x90"]
    return {
        "unknown_marker": insert(cs, cod, b"\xff\x30\x00\x04\x00\x00"),
        "com_in_tile_header": insert(cs, sot + 12, com),
        "tile_part_psot_0": put(cs, sot + 6, bytes(4)),
        "tile_part_tnsot_0": put(cs, sot + 11, b"\x00"),
        "no_eoc": cs[:-2],
        "after_eoc": cs + b"\x00\x11\x22",
        "garbage_for_eoc": cs[:-2] + b"\x12\x34",
        "siz_not_first": insert(cs, 2, com),
        "no_qcd": cs[:qcd] + cs[qcd + 2 + struct.unpack(">H", cs[qcd + 2:qcd + 4])[0]:],
        "cod_twice": insert(cs, qcd, cs[cod:cod + 2 + struct.unpack(">H", cs[cod + 2:cod + 4])[0]]),
        "cod_progression_7": put(cs, cod + 5, b"\x07"),
        "cod_no_layers": put(cs, cod + 6, b"\x00\x00"),
        "cod_mct_2": put(cs, cod + 8, b"\x02"),
        "cod_scod_8": put(cs, cod + 4, b"\x08"),
        "cod_cblk_11": put(cs, cod + 10, b"\x09"),
        "cod_transform_2": put(cs, cod + 13, b"\x02"),
        "cod_34_resolutions": put(cs, cod + 9, b"\x21"),
        "cod_mixed_ht": put(cs, cod + 12, b"\x80"),
        "qcd_cut": put(cs, qcd + 2, struct.pack(">H", struct.unpack(">H", cs[qcd + 2:qcd + 4])[0]
                                                 - 1)),
        "siz_precision_32": put(cs, siz + 42, b"\x1f"),
        "siz_dx_0": put(cs, siz + 43, b"\x00"),
        "siz_tile_0": put(cs, siz + 20, bytes(4)),
        "siz_component_count": put(cs, siz + 38, b"\x00\x04"),
        "siz_huge": put(put(cs, siz + 6, struct.pack(">I", (1 << 20) + 1)), siz + 22,
                        struct.pack(">I", (1 << 20) + 1)),
        "siz_huge_pixels": put(put(put(put(cs, siz + 6, struct.pack(">I", 40000)), siz + 10,
                                       struct.pack(">I", 40000)), siz + 22,
                                   struct.pack(">I", 40000)), siz + 26, struct.pack(">I", 40000)),
        "sot_bad_tile": put(cs, sot + 4, b"\x00\x07"),
        "sot_part_1": put(cs, sot + 10, b"\x01"),
        "sot_length_13": put(cs, sot + 6, struct.pack(">I", 13)),
        "sot_too_long": put(cs, sot + 6, struct.pack(">I", len(cs))),
        "tiles_tnsot_0": _zero_tnsot(tiled, sots),
        "tiles_second_tile_cut_after_sot": tiled[:sots[1] + 2],
        "tiles_in_reverse": _reverse_tiles(tiled, sots),
        "tiles_plt_in_main_header": insert(tiled, tm[b"\xff\x5c"], b"\xff\x58\x00\x04\x00\x05"),
        "tlm_wrong_size": insert(cs, qcd, b"\xff\x55\x00\x07\x00\x50\x00\x01\x02"),
        "tlm_short": insert(cs, qcd, b"\xff\x55\x00\x03\x00"),
        "eph_missing": _break_eph(_codestream(writer, csty=6, rates="20,5")),
        "eph_past_the_tile_part": _eph_past_tile_part(_codestream(writer, csty=4)),
        "rpcl_33_resolutions": _levels(_codestream(writer, prog="RPCL", rates="30,10,3"), 32),
        "pcrl_17_resolutions": _levels(_codestream(writer, prog="PCRL", irreversible=1,
                                                   rates="30,10,3"), 16),
        "cprl_32_resolutions": _levels(_codestream(writer, prog="CPRL", rates="30,10,3"), 31),
        # a POC whose levels hold only empty bands: OpenJPEG skips those
        # packets and counts the component as decoded to its top level
        "poc_skipped_levels": _levels(writer(
            mf.picture(2, 21, 17, noise=5), mode=47, prog="RPCL", cblk="16x8", irreversible=1,
            roi="2,7", poc="1:3:2:3:6:3:RPCL/1:0:0:2:2:2:RPCL/1:3:1:2:7:3:PCRL"), 12),
    }


def _levels(cs: bytes, n: int) -> bytes:
    """``cs`` with its COD's decomposition levels set to ``n``."""
    cod = _markers(cs)[b"\xff\x52"]
    return cs[:cod + 9] + bytes([n]) + cs[cod + 10:]


def _break_eph(cs: bytes) -> bytes:
    """``cs`` with its third EPH marker's second byte changed."""
    ephs = [i for i in range(len(cs) - 1) if cs[i:i + 2] == b"\xff\x92"]
    return cs[:ephs[2] + 1] + b"\x00" + cs[ephs[2] + 2:]


def _eph_past_tile_part(cs: bytes) -> bytes:
    """``cs`` with its tile-part's Psot cut to end one byte into the first
    packet's EPH marker."""
    sot = _markers(cs)[b"\xff\x90"]
    eph = cs.index(b"\xff\x92", sot)
    return cs[:sot + 6] + struct.pack(">I", eph + 1 - sot) + cs[sot + 10:]


def _zero_tnsot(cs: bytes, sots: list) -> bytes:
    out = bytearray(cs)
    for s in sots:
        out[s + 11] = 0
    return bytes(out)


def _reverse_tiles(cs: bytes, sots: list) -> bytes:
    ends = sots[1:] + [len(cs) - 2]
    parts = [cs[s:e] for s, e in zip(sots, ends)]
    return cs[:sots[0]] + b"".join(reversed(parts)) + cs[-2:]


MARKER_CASES = ("unknown_marker", "com_in_tile_header", "tile_part_psot_0", "tile_part_tnsot_0",
                "no_eoc", "after_eoc", "garbage_for_eoc", "siz_not_first", "no_qcd", "cod_twice",
                "cod_progression_7", "cod_no_layers", "cod_mct_2", "cod_scod_8", "cod_cblk_11",
                "cod_transform_2", "cod_34_resolutions", "cod_mixed_ht", "qcd_cut",
                "siz_precision_32", "siz_dx_0", "siz_tile_0", "siz_component_count", "siz_huge",
                "siz_huge_pixels", "sot_bad_tile", "sot_part_1", "sot_length_13", "sot_too_long",
                "tiles_tnsot_0", "tiles_second_tile_cut_after_sot", "tiles_in_reverse",
                "tiles_plt_in_main_header", "tlm_wrong_size", "tlm_short", "eph_missing",
                "eph_past_the_tile_part", "rpcl_33_resolutions", "pcrl_17_resolutions",
                "cprl_32_resolutions", "poc_skipped_levels")


@pytest.mark.parametrize("case", MARKER_CASES)
def test_marker_rules_match_cv2(tmp_path, writer, case):
    out = _against_cv2(tmp_path, _marker_cases(writer)[case])
    if case.startswith("siz_huge"):
        assert out == {"color": "raises", "gray": "raises"}


def _coc_qcc_cases(writer, irreversible: int, mct: int = 0) -> dict:
    """COC and QCC markers assembled by hand into a codestream of three
    independent components: equal to or unlike COD's and QCD's values,
    before and after them (OpenJPEG lets a later COD or QCD overwrite every
    component), out of range, cut short, in a tile-part header. With
    ``mct`` COD's component transform runs over them, and the ``mct_*``
    cases give one or two of the first three components the other wavelet
    (component 0's picks the transform)."""
    cs = writer(mf.picture(29, 33, 8, noise=6), mct=mct, irreversible=irreversible, rates="20,5")
    if mct:
        return {"mct_same": cs,
                **{f"mct_flip_{''.join(map(str, comps))}": mf.flip_transform(cs, comps)
                   for comps in ((0,), (1,), (2,), (1, 2), (0, 2))}}
    m = _markers(cs)
    cod, qcd, sot = m[b"\xff\x52"], m[b"\xff\x5c"], m[b"\xff\x90"]
    spcod = cs[cod + 9:cod + 14]  # levels, code-block sides, style, transform
    qcd_body = cs[qcd + 4:qcd + 2 + struct.unpack(">H", cs[qcd + 2:qcd + 4])[0]]

    def seg(code: bytes, payload: bytes) -> bytes:
        return code + struct.pack(">H", 2 + len(payload)) + payload

    def coc(comp: int, sty: int, sp: bytes) -> bytes:
        return seg(b"\xff\x53", bytes([comp, sty]) + sp)

    def qcc(comp: int, body: bytes) -> bytes:
        return seg(b"\xff\x5d", bytes([comp]) + body)

    def ins(at: int, marker: bytes) -> bytes:
        return cs[:at] + marker + cs[at:]

    small_blocks = bytes([spcod[0], 3, 3]) + spcod[3:]
    other_guard = bytes([qcd_body[0] ^ 0x20]) + qcd_body[1:]
    in_tile = cs[:sot + 12] + coc(1, 0, small_blocks) + cs[sot + 12:]
    psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0] + 9
    return {
        "coc_same_after_cod": ins(qcd, coc(1, 0, spcod)),
        "coc_blocks_after_cod": ins(qcd, coc(1, 0, small_blocks)),
        "coc_blocks_before_cod": ins(cod, coc(1, 0, small_blocks)),
        "coc_transform": ins(qcd, coc(2, 0, spcod[:4] + bytes([1 - spcod[4]]))),
        "coc_three_levels": ins(qcd, coc(1, 0, bytes([2]) + spcod[1:])),
        "coc_precincts": ins(qcd, coc(1, 1, spcod + bytes([0x55] * (spcod[0] + 1)))),
        "coc_vsc": ins(qcd, coc(0, 0, spcod[:3] + bytes([8]) + spcod[4:])),
        "coc_bad_component": ins(qcd, coc(3, 0, spcod)),
        "coc_short": ins(qcd, seg(b"\xff\x53", bytes([1, 0, 5, 4]))),
        "coc_in_tile_header": in_tile[:sot + 6] + struct.pack(">I", psot) + in_tile[sot + 10:],
        "qcc_after_qcd": ins(sot, qcc(1, other_guard)),
        "qcc_before_qcd": ins(qcd, qcc(1, other_guard)),
        "qcc_derived": ins(sot, qcc(2, bytes([0x41, 0x48, 0x00]))),
        "qcc_bad_component": ins(sot, qcc(5, qcd_body)),
        "qcc_short": ins(sot, seg(b"\xff\x5d", bytes([1]))),
    }


COC_QCC = ("coc_same_after_cod", "coc_blocks_after_cod", "coc_blocks_before_cod", "coc_transform",
           "coc_three_levels", "coc_precincts", "coc_vsc", "coc_bad_component", "coc_short",
           "coc_in_tile_header", "qcc_after_qcd", "qcc_before_qcd", "qcc_derived",
           "qcc_bad_component", "qcc_short", "mct_same", "mct_flip_0", "mct_flip_1",
           "mct_flip_2", "mct_flip_12", "mct_flip_02")


@pytest.mark.parametrize("irreversible", [0, 1])
@pytest.mark.parametrize("case", COC_QCC)
def test_coc_qcc_match_cv2(tmp_path, writer, case, irreversible):
    mct = int(case.startswith("mct_"))
    out = _against_cv2(tmp_path, _coc_qcc_cases(writer, irreversible, mct)[case])
    if mct:  # cv2 decodes each (ROADMAP C13, which the port refused)
        assert out["color"].shape == (29, 33, 3) and out["gray"].shape == (29, 33)


def test_decoded_area_outside_the_component_matches_cv2(tmp_path, writer):
    """An image offset past the area of the last level a POC reaches:
    OpenJPEG's ``opj_j2k_update_image_data`` fails the decode and cv2
    returns None, in colour and in gray (the port raised
    ``UnsupportedImage``)."""
    img = mf.picture(29, 33, 8, noise=6)
    for settings in (dict(offset="64x64", poc="1:0:0:1:3:3:LRCP"),
                     dict(offset="64x64", poc="1:0:0:1:1:3:LRCP"),
                     dict(offset="64x64", tile="16x16", tileoff="60x60",
                          poc="1:0:0:1:3:3:LRCP")):
        out = _against_cv2(tmp_path, writer(img, **settings), file=False)
        assert out == {"color": None, "gray": None}, settings


PACKED = [(layout, kind, markers, order)
          for layout in ("one_tile", "tiles_rpcl", "tile_parts", "styles_97")
          for kind in ("ppt", "ppm") for markers, order in ((1, None), (3, None), (3, (1, 0, 2)))]


@pytest.mark.parametrize("layout,kind,markers,order", PACKED)
def test_packed_headers_match_cv2(tmp_path, writer, layout, kind, markers, order):
    """Packet headers moved by hand into PPT or PPM markers, split across
    markers written in and out of Zppt / Zppm order: equal to cv2, which
    reads them as the headers in the packets (PPT markers that repeat a
    Zppt in each tile-part of a tile, as ``tile_parts`` does, give None)."""
    settings = {"one_tile": dict(rates="20,5"),
                "tiles_rpcl": dict(tile="16x16", rates="20,5,1", prog="RPCL"),
                "tile_parts": dict(tile="16x16", tp="R", rates="20,5"),
                "styles_97": dict(mode=63, irreversible=1, rates="10,3")}[layout]
    cs = writer(mf.picture(29, 33, 9, noise=6), csty=6, **settings)
    out = _against_cv2(tmp_path, mf.packed_headers(cs, kind, markers, order))
    plain = _cv2(lambda: cv2.imdecode(np.frombuffer(cs, np.uint8), cv2.IMREAD_COLOR))
    if not (layout == "tile_parts" and kind == "ppt"):
        assert np.array_equal(out["color"], plain)


def test_packed_header_rules_match_cv2(tmp_path, writer):
    """PPM and PPT markers OpenJPEG refuses: a Zppm read twice, a PPT beside
    a PPM, an Nppm longer than the headers, an Nppm cut short."""
    cs = writer(mf.picture(29, 33, 9, noise=6), csty=6, rates="20,5")
    ppm, ppt = mf.packed_headers(cs, "ppm", 2), mf.packed_headers(cs, "ppt", 2)
    first = ppm.index(b"\xff\x60")
    n = struct.unpack(">H", ppm[first + 2:first + 4])[0]
    sot = ppt.index(b"\xff\x90")
    ppt_seg = ppt[ppt.index(b"\xff\x61"):]
    ppt_seg = ppt_seg[:2 + struct.unpack(">H", ppt_seg[2:4])[0]]
    cases = {
        "zppm_twice": ppm[:first] + ppm[first:first + 2 + n] + ppm[first:],
        "ppt_beside_ppm": ppm[:sot] + ppm[sot:sot + 12] + ppt_seg + ppm[sot + 12:],
        "nppm_too_long": ppm[:first + 5] + struct.pack(">I", 999_999) + ppm[first + 9:],
        "nppm_cut": ppm[:first + 2] + struct.pack(">H", 5) + bytes([0, 0, 0]) + ppm[first + 2 + n:],
    }
    for name, data in cases.items():
        out = _against_cv2(tmp_path, data)
        assert out == {"color": None, "gray": None}, name


def test_unported_forms_raise(writer):
    """The forms the decoder leaves out (HTJ2K code-blocks, the CAP marker,
    Part 2's MCC) raise ``UnsupportedImage``
    naming ROADMAP A10 part 3, step 5, whatever cv2 makes of them: the
    port never returns a guess."""
    cs = _codestream(writer)
    m = _markers(cs)
    cod, qcd = m[b"\xff\x52"], m[b"\xff\x5c"]

    def insert(seg: bytes) -> bytes:
        return cs[:qcd] + seg + cs[qcd:]

    cases = {
        "cap": insert(b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"),
        "mcc": insert(b"\xff\x75\x00\x04\x00\x00"),
        "ht_codeblocks": cs[:cod + 12] + b"\x40" + cs[cod + 13:],
    }
    for name, data in cases.items():
        with pytest.raises(UnsupportedImage, match=STEP):
            imdecode(data)


# -- cuts and corruptions ------------------------------------------------------

CUT = ("cv2_33x45", "pil97_tiles_rate", "box_pclr")


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name + ".jp2"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", CUT)
def test_every_cut_matches_cv2(name):
    data = _fixture(name)
    assert len(data) <= 2048
    decoded = 0
    for n in range(1, len(data)):
        cut = data[:n]
        want = _cv2(lambda: cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR))
        assert _same(_port(lambda: imdecode(cut)), want), n
        decoded += isinstance(want, np.ndarray)
    assert decoded < len(data) // 10  # nearly every cut is refused, as by cv2


@pytest.mark.parametrize("layout", [dict(tile="8x8"), dict(tile="8x8", tp="R", rates="10,3"),
                                    dict(tp="R", rates="10,3"), dict(tile="8x8", tp="L",
                                                                    rates="10,3")],
                         ids=["tiles", "tiles_parts_by_resolution", "one_tile_parts",
                              "tiles_parts_by_layer"])
def test_cuts_at_tile_parts_match_cv2(writer, layout):
    """Data cut at each tile-part's SOT marker (before it, after its code,
    inside its segment): the tiles read so far decode where cv2 decodes
    them (OpenJPEG's end of stream before a tile-part), and OpenJPEG's look
    ahead for one more tile-part of a complete tile refuses the rest."""
    data = writer(mf.picture(24, 24, 5, noise=5), **layout)
    sots = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\x90"]
    decoded = 0
    for s in sots[1:]:
        for n in (s, s + 1, s + 2, s + 3, s + 7):
            cut = data[:n]
            want = _cv2(lambda: cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR))
            assert _same(_port(lambda: imdecode(cut)), want), (s, n - s)
            decoded += isinstance(want, np.ndarray)
    assert decoded >= 1


@pytest.mark.parametrize("name", CUT + ("mode_all_97", "poc3", "sop_eph_rpcl"))
def test_corrupt_bytes_match_cv2(name):
    """Seeded flips of one or three bytes past the signature, in both
    modes.  A flip that makes an unported form (ROADMAP A10 part 3, step 5:
    say a code-block style with the HT bit) raises ``UnsupportedImage``
    naming it; no flip of these files does more than once."""
    data = _fixture(name)
    rng = np.random.default_rng(sum(name.encode()))
    unported = 0
    for k in range(60):
        b = bytearray(data)
        for _ in range(1 if k < 40 else 3):
            b[int(rng.integers(4, len(b)))] ^= int(rng.integers(1, 256))
        b = bytes(b)
        buf = np.frombuffer(b, np.uint8)
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            want = _cv2(lambda: cv2.imdecode(buf, flag))
            try:
                got = _port(lambda: imdecode(b, mode))
            except UnsupportedImage as e:
                assert STEP in str(e)
                unported += 1
                continue
            assert _same(got, want), (k, mode)
    assert unported <= 2, unported


# -- the committed fixtures -------------------------------------------------------

FIXTURE_NAMES = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(FIXTURES,
                                                                               "*.jp2")))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixtures_equal_cv2_and_the_port(name):
    path = os.path.join(FIXTURES, name + ".jp2")
    stored = np.load(path[:-4] + ".npz")
    data = _fixture(name)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        for decode, cv_read, port_read in (
                (False, lambda: cv2.imread(path, flag), lambda: imread(path, mode)),
                (True, lambda: cv2.imdecode(np.frombuffer(data, np.uint8), flag),
                 lambda: imdecode(data, mode))):
            assert mf.matches(stored, mode, decode, _cv2(cv_read)), ("stored vs cv2", mode, decode)
            assert mf.matches(stored, mode, decode, _port(port_read)), ("port", mode, decode)


def test_fixture_set_is_complete():
    names = set(FIXTURE_NAMES)
    for t in mf.TIMED:
        assert t[:-4] in names
    assert {f"coco_{i:02d}" for i in range(mf.COCO_SCENES)} <= names
    assert set(FORMS) <= names and len(names) >= 100
    size = sum(os.path.getsize(p) for p in glob.glob(os.path.join(FIXTURES, "*")))
    assert size < 2_000_000, size
    coco = [os.path.getsize(os.path.join(FIXTURES, f"coco_{i:02d}.jp2"))
            for i in range(mf.COCO_SCENES)]
    assert max(coco) <= 40_000 and sum(coco) < 1_100_000, coco


# -- a COCO tree of JPEG 2000 images ---------------------------------------------------


def _jpeg2000_coco_tree(root: str, n: int, ext: str = ".jpg") -> tuple[str, str]:
    """``n`` committed 480 x 640 JPEG 2000 scenes as a COCO tree (polygon
    people from ``coco_scenes.json``, 17 visible keypoints each), the files
    named ``<id><ext>``."""
    with open(os.path.join(FIXTURES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for i in range(n):
        name = f"{i:012d}{ext}"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(_fixture(f"coco_{i:02d}"))
        images.append({"id": i, "file_name": name, "height": scenes["height"],
                       "width": scenes["width"]})
        for j, (cx, cy, ax, ay) in enumerate(scenes["people"][i]):
            ang = 2 * np.pi * np.arange(24) / 24
            ring = np.stack([cx + ax * np.cos(ang), cy + ay * np.sin(ang)], 1).round(2)
            kang = 2 * np.pi * np.arange(17) / 17
            keypoints = np.stack([cx + 0.6 * ax * np.cos(kang), cy + 0.6 * ay * np.sin(kang),
                                  np.full(17, 2)], 1).astype(int)
            annotations.append({"id": 2 * i + j, "image_id": i, "category_id": 1,
                                "segmentation": [ring.ravel().tolist()],
                                "bbox": [round(cx - ax, 2), round(cy - ay, 2), round(2 * ax, 2),
                                         round(2 * ay, 2)],
                                "keypoints": keypoints.ravel().tolist()})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "person"}], "images": images,
                   "annotations": annotations}, f)
    return img_dir, ann


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_jpeg2000_coco_tree_converts_as_jax(tmp_path):
    """JPEG 2000 images under ``.jpg`` names (cv2 reads by content): both
    converters copy them and write the same tree, byte for byte (the
    ``.jpg`` mix previews are cv2's JPEG bytes in both)."""
    img_dir, ann = _jpeg2000_coco_tree(str(tmp_path / "src"), 6)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port, progress=False) == 6
    assert jconv.transfer_coco(img_dir, ann, ref, progress=False) == 6
    files = _files(ref)
    assert _files(port) == files and len(files) == 6 * 7
    for rel in files:
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            assert a.read() == b.read(), rel
    for i in range(6):
        with open(os.path.join(port, "image", f"{i:012d}.jpg"), "rb") as f:
            assert f.read() == _fixture(f"coco_{i:02d}")


def _tree_files(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


def _same_bytes(port: str, jax: str) -> dict:
    """The two converted trees hold the same files with the same bytes (the
    records name the source directory, the same for both)."""
    got, want = _tree_files(port), _tree_files(jax)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    return got


def test_jp2_named_coco_tree_equals_the_jax_packages(tmp_path):
    """Under ``.jp2`` names (one ``.JP2``) the mix previews are JPEG 2000
    files that cv2's encoder writes (rate 4, cut by the allocation): both
    packages' ``transfer_coco`` write the same tree, byte for byte."""
    img_dir, ann = _jpeg2000_coco_tree(str(tmp_path / "src"), 2, ext=".jp2")
    os.rename(os.path.join(img_dir, "000000000001.jp2"), os.path.join(img_dir, "000000000001.JP2"))
    with open(ann) as f:
        coco = json.load(f)
    coco["images"][1]["file_name"] = "000000000001.JP2"
    with open(ann, "w") as f:
        json.dump(coco, f)
    assert jconv.transfer_coco(img_dir, ann, str(tmp_path / "jax"), progress=False) == 2
    assert tconv.transfer_coco(img_dir, ann, str(tmp_path / "port"), progress=False) == 2
    files = _same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))
    previews = sorted(f for f in files if f.startswith("mix"))
    assert previews == [os.path.join("mix", "000000000000.jp2"),
                        os.path.join("mix", "000000000001.JP2")]
    for rel in previews:
        assert files[rel].startswith(b"\x00\x00\x00\x0cjP  ")


def test_jp2_named_ochuman_tree_equals_the_jax_packages(tmp_path):
    """An OCHuman tree of ``.jp2`` images (people with holes, keypoints):
    both packages' ``transfer_ochuman`` write the same tree, its ``.jp2``
    mix previews included, byte for byte."""
    with open(os.path.join(FIXTURES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    img_dir = tmp_path / "src" / "images"
    img_dir.mkdir(parents=True)
    images = []
    for i in range(2):
        name = f"{i:06d}.jp2"
        (img_dir / name).write_bytes(_fixture(f"coco_{i + 2:02d}"))
        anns = []
        for cx, cy, ax, ay in scenes["people"][i + 2]:
            ang = 2 * np.pi * np.arange(20) / 20
            outer = np.stack([cx + ax * np.cos(ang), cy + ay * np.sin(ang)], 1).round(1)
            inner = np.stack([cx + ax / 5 * np.cos(ang), cy + ay / 5 * np.sin(ang)], 1).round(1)
            kang = 2 * np.pi * np.arange(19) / 19
            kps = np.stack([cx + 0.6 * ax * np.cos(kang), cy + 0.6 * ay * np.sin(kang),
                            np.full(19, 1)], 1).round(1)
            anns.append({"bbox": [int(cx - ax), int(cy - ay), int(cx + ax), int(cy + ay)],
                         "keypoints": kps.ravel().tolist(),
                         "segms": {"outer": [outer.ravel().tolist()],
                                   "inner": [inner.ravel().tolist()]}})
        images.append({"file_name": name, "width": scenes["width"], "height": scenes["height"],
                       "annotations": anns})
    ann = tmp_path / "src" / "ochuman.json"
    ann.write_text(json.dumps({"images": images}))
    for pkg, out in ((jconv, "jax"), (tconv, "port")):
        assert pkg.transfer_ochuman(str(ann), str(img_dir), str(tmp_path / out),
                                    progress=False) == 2
    files = _same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(f for f in files if f.startswith("mix")) == [
        os.path.join("mix", "000000.jp2"), os.path.join("mix", "000001.jp2")]


def test_jp2_supervisely_project_equals_the_jax_packages(tmp_path):
    """A Supervisely project whose images are ``.jp2`` files: both
    converters read each image and re-encode it with ``write_image`` (under
    ``<n>.png``, as for every Supervisely image), and write the same tree,
    byte for byte."""
    root = tmp_path / "proj"
    for ds in ("ds0", "ds1"):
        (root / ds / "ann").mkdir(parents=True)
        (root / ds / "img").mkdir()
    objects = [
        {"classTitle": "person_poly", "geometryType": "polygon", "instance": "A",
         "points": {"exterior": [[200, 100], [420, 90], [440, 400], [180, 380]],
                    "interior": [[[260, 200], [330, 200], [300, 280]]]}},
        {"classTitle": "nose", "geometryType": "point", "instance": "A",
         "points": {"exterior": [[300, 150]], "interior": []}}]
    for k, ds in enumerate(("ds0", "ds1")):
        (root / ds / "img" / "item.jp2").write_bytes(_fixture(f"coco_{k + 4:02d}"))
        (root / ds / "ann" / "item.json").write_text(json.dumps(
            {"size": {"height": 480, "width": 640}, "objects": objects}))
    for pkg, out in ((jconv, "jax"), (tconv, "port")):
        assert pkg.transfer_supervisely_to_common(str(root), str(tmp_path / out),
                                                  progress=False) == 2
    files = _same_bytes(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.path.join("image", "00000.png") in files
    assert os.path.join("mix", "00001.png") in files


def test_jpeg2000_coco_tree_trains(tmp_path):
    """The converted JPEG 2000 tree read by both datasets (every field
    equal), then a few port train steps on it."""
    img_dir, ann = _jpeg2000_coco_tree(str(tmp_path / "src"), 2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port_dir, progress=False) == 2
    assert jconv.transfer_coco(img_dir, ann, jax_dir, progress=False) == 2
    port, ref = InstanceCommonDataset(port_dir, canvas=320), JaxDataset(jax_dir, canvas=320)
    assert len(port) == len(ref) == 4
    for i in range(4):
        got, want = port.fetch(i), ref.fetch(i)
        for field in ("image", "mask", "image_hw", "obj_box", "mask_box", "keypoints"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                          err_msg=f"sample {i} {field}")
    cfg = TrainConfig(train_dataset_dir=port_dir, val_dataset_dir=port_dir,
                      checkpoint_dir=str(tmp_path / "ckpt"), out_dir=str(tmp_path / "runs"),
                      canvas=320, out_size=64, in_channels=20, bfloat16=False, batch_size=4,
                      learning_rate=3e-3, save_iou_gate=0.0, log_images=False)
    batch = host_batch([port.fetch(i) for i in range(4)])
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(0))
    state = TrainState.create(model, cfg.learning_rate)
    train_step = make_train_step(cfg)
    draws = draw_augment(4, augment_config(cfg, True))
    losses = []
    for _ in range(2):
        state, metrics = train_step(state, batch, draws)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses


def test_reading_jpeg2000_loads_no_openjpeg():
    """A process that decodes JPEG 2000 through the port maps no OpenJPEG
    (nor cv2 or PIL): the decoder is the port's own C++ (``build/native/
    libjpeg2000_<hash>.so``, built from ``ops/native/jpeg2000.cpp``)."""
    code = (
        "import sys\n"
        "from instancesegmentation_tpu_torch.core.imread import imread\n"
        f"img = imread({os.path.join(FIXTURES, 'mode_all_97.jp2')!r})\n"
        f"img = imread({os.path.join(FIXTURES, 'box_pclr.jp2')!r})\n"
        "import os, re\n"
        "files = {l.split()[-1] for l in open('/proc/self/maps') if '/' in l}\n"
        "names = {os.path.basename(f) for f in files}\n"
        "assert not [n for n in names if re.match(r'libopenjp2', n)]\n"
        "assert [f for f in files if re.search(r'build/native/libjpeg2000_[0-9a-f]+\\.so$', f)]\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

"""C6: ``imdecode`` of JPEG data whose end differs from a whole file, against
live ``cv2.imdecode`` (and ``imread`` against ``cv2.imread``), in both read
modes: every pixel equal where cv2 decodes, ``FileNotFoundError`` exactly
where cv2 returns None.

cv2's memory source suspends where libjpeg's file source inserts an end
marker, so ``cv2.imdecode`` gives None for a file whose decode reads past
the end of its data: anywhere in a multi-scan file (progressive, or a
sequential file with more than one scan), up to the last MCU of a single
scan (libjpeg's bit buffer reads ahead, up to 57 bits per fill, so a data
end close behind the last MCU fails it too).  ``cv2.imread`` decodes the
same bytes, the missing end read as an end marker.

- every cut length of the small committed fixtures (baseline, progressive,
  restarts, arithmetic, lossless) and a sample of the 480 x 640 ones;
- whole files with ten zero bytes after them, their end marker doubled,
  replaced by ten zero bytes or ten ``FF`` bytes, its last byte replaced by
  a stuffed zero;
- the committed ``c6_*`` fixtures against the decodes stored beside them.
"""
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu_torch.core.imread import imdecode, imread

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SMALL = ("small_17x9_444_q50", "small_37x53_422_q95_opt_rst", "gray_37x53_prog",
         "form_arith_37x53_420_rst", "form_arith_prog_37x53_422_dac", "form_lossless_rgb_37x53",
         "form_411_37x53", "form_440_37x53_prog", "form_ycck_37x53_prog")
LARGE = ("base_480x640_420_q95", "prog_480x640_420_q95", "form_arith_480x640_420")


def _decode_as_cv2(data: bytes) -> dict:
    """``imdecode`` against ``cv2.imdecode`` in both modes: {mode: outcome}."""
    outcome = {}
    buf = np.frombuffer(data, np.uint8)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(buf, flag)
        if want is None:
            with pytest.raises(FileNotFoundError):
                imdecode(data, mode)
            outcome[mode] = "none"
            continue
        want = want[..., ::-1] if want.ndim == 3 else want
        np.testing.assert_array_equal(imdecode(data, mode), want, err_msg=mode)
        outcome[mode] = "decoded"
    return outcome


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name + ".jpg"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", SMALL)
def test_every_cut_of_the_small_fixtures_matches_cv2_imdecode(name):
    """Every cut length of a small fixture (from its second byte on): the
    cuts inside the scan data give None, where ``cv2.imread`` of the same
    bytes decodes them."""
    data = _read(name)
    outcomes = [_decode_as_cv2(data[:cut]) for cut in range(2, len(data) + 1)]
    assert outcomes[-1]["color"] == "decoded"
    assert sum(o["color"] == "none" for o in outcomes) > len(data) // 2


@pytest.mark.parametrize("name", LARGE)
def test_sampled_cuts_of_the_large_fixtures_match_cv2_imdecode(name, tmp_path):
    """The last 24 cut lengths and 24 more spread over a 480 x 640 file;
    ``imread`` of the same cut files still reads them as ``cv2.imread``
    (which decodes every cut past the first scan's header)."""
    data = _read(name)
    cuts = sorted(set(range(len(data) - 24, len(data))) |
                  set(np.linspace(200, len(data) - 25, 24).astype(int).tolist()))
    for cut in cuts:
        _decode_as_cv2(data[:cut])
    path = str(tmp_path / "cut.jpg")
    for cut in cuts[::8]:
        with open(path, "wb") as f:
            f.write(data[:cut])
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises(FileNotFoundError):
                imread(path, "color")
        else:
            np.testing.assert_array_equal(imread(path, "color"), want[..., ::-1])
    assert cv2.imread(path, cv2.IMREAD_COLOR) is not None


VARIANTS = {
    "whole": lambda d: d,
    "ten_zeros_after": lambda d: d + bytes(10),
    "end_marker_twice": lambda d: d + b"\xff\xd9",
    "end_marker_to_zeros": lambda d: d[:-2] + bytes(10),
    "end_marker_to_ff": lambda d: d[:-2] + b"\xff" * 10,
    "last_byte_stuffed": lambda d: d[:-1] + b"\x00",
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("form", ["baseline", "progressive", "restarts"])
def test_end_variants_match_cv2_imdecode(form, variant):
    """The six ends of the issue's table on 96 x 128 cv2 files (and the
    committed small ones): what cv2's memory source makes of each."""
    img = cv2.imread(os.path.join(FIXTURES, "base_480x640_420_q95.jpg"))[:96, :128]
    params = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "restarts": [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]}[form]
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95] + params)
    _decode_as_cv2(VARIANTS[variant](buf.tobytes()))
    for name in SMALL:
        _decode_as_cv2(VARIANTS[variant](_read(name)))


@pytest.mark.parametrize("name", sorted(os.path.basename(p)[:-4] for p in
                                        glob.glob(os.path.join(FIXTURES, "c6_*.jpg"))))
def test_c6_fixtures_match_their_stored_decodes(name):
    """The committed C6 fixtures: ``imread`` gives the stored ``cv2.imread``
    arrays, ``imdecode`` the stored ``cv2.imdecode`` ones or
    ``FileNotFoundError`` where none is stored; the stored arrays are still
    cv2's."""
    path = os.path.join(FIXTURES, name + ".jpg")
    stored = np.load(path[:-4] + ".npz")
    data = _read(name)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        np.testing.assert_array_equal(imread(path, mode), stored[mode])
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if "decode_" + mode in stored:
            np.testing.assert_array_equal(imdecode(data, mode), stored["decode_" + mode])
            np.testing.assert_array_equal(want[..., ::-1] if want.ndim == 3 else want,
                                          stored["decode_" + mode])
        else:
            assert want is None
            with pytest.raises(FileNotFoundError):
                imdecode(data, mode)

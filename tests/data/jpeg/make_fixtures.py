"""Write the JPEG fixtures of the port's decoder, with cv2's decoded arrays
beside them.

    python tests/data/jpeg/make_fixtures.py

Each ``<name>.jpg`` is written by ``cv2.imencode`` from a seeded image (a
480 x 640 baseline and a progressive 4:2:0 file at quality 95, the sizes a
dataset holds, and small files of the other forms: 4:4:4, 4:2:2 with
optimised tables and restart markers, a progressive gray file, an EXIF
orientation, files cut inside their scan data).  ``<name>.npz`` holds what
``cv2.imread`` gives for it: ``color`` (RGB, as the readers convert it) and
``gray``.  ``tests/test_torch_port_imread.py`` holds the stored arrays
against cv2 and the port's decoder; ``chip_smoke.py`` holds the port's
decoder against them on a machine without cv2.

The forms' fixtures (``form_<name>.jpg``) hold one file of each form that
no writer here made before: cv2's 4:1:1 and 4:4:0, PIL's CMYK, YCCK (its
Adobe transform byte set to 2) and RGB-coded files, and ``jpeg_writer.py``'s
arithmetic-coded (sequential with restarts, progressive with DAC
conditioning, one cut in its data), lossless, luma-upsampled and h4v2 files,
a 480 x 640 CMYK and a 480 x 640 arithmetic 4:2:0 file for the card's
timings, and the forms cv2 refuses (a true 12-bit file, a hierarchical SOF5
header, a sampling ratio that is not a whole number, which cv2 reads as
gray only).  Their ``.npz`` holds ``color`` and ``gray`` only for a read mode
cv2 decodes.

The C6 fixtures ``c6_<name>.jpg`` are 48 x 64 files whose end cv2's two
sources read apart (cut by a byte, the end marker replaced by zero bytes or
its last byte by a stuffed zero, baseline, progressive and with restart
markers); their ``.npz`` adds ``decode_color`` and ``decode_gray``, what
``cv2.imdecode`` gives for the bytes, where it decodes
(``python make_fixtures.py --c6`` writes only these).

The encoder's fixtures ``enc_<name>.jpg`` are ``cv2.imencode(".jpg")`` with
cv2's default parameters (quality 95, 4:2:0) of the pixels stored beside
them as ``pixels`` in ``enc_<name>.npz`` (RGB, or gray): a 480 x 640 image
(the decode of ``base_480x640_420_q95.jpg``), random and smooth small ones,
gray ones.  ``tests/test_torch_port_jpeg_encode.py`` holds them against cv2
and the port's encoder; ``chip_smoke.py`` holds the port's encoder against
them on the card's machine.
"""
import io
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

from jpeg_writer import adobe, jfif, write_jpeg

HERE = os.path.dirname(os.path.abspath(__file__))


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """A BGR image with smooth shading, edges and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([96 + 60 * np.sin(x / 53 + y / 71), 128 + 50 * np.cos(x / 37 - y / 45),
                    40 + 0.2 * x + 0.15 * y], axis=-1)
    for _ in range(6):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.05, 0.3) * min(h, w)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def exif_app1(orientation: int) -> bytes:
    tiff = (b"MM\x00*" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def encode(img: np.ndarray, quality: int, sampling: int, progressive=False, optimize=False,
           rst=0) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive), cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    assert ok
    return buf.tobytes()


def fixtures() -> dict[str, bytes]:
    s420, s422, s444 = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    big = picture(480, 640, 0)
    small = picture(37, 53, 1)
    cut = picture(96, 128, 2)
    gray = cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)
    base = encode(cut, 90, s420)
    prog = encode(cut, 90, s420, progressive=True)
    plain = encode(small, 80, s420)
    return {
        "base_480x640_420_q95": encode(big, 95, s420),
        "prog_480x640_420_q95": encode(big, 95, s420, progressive=True),
        "small_17x9_444_q50": encode(picture(17, 9, 3), 50, s444),
        "small_37x53_422_q95_opt_rst": encode(small, 95, s422, optimize=True, rst=2),
        "gray_37x53_prog": encode(gray, 90, s444, progressive=True),
        "orient6_37x53_420": plain[:2] + exif_app1(6) + plain[2:],
        "cut_base_96x128_420": base[:len(base) * 2 // 3],
        "cut_prog_96x128_420": prog[:len(prog) // 2],
    }


def _pil(img: np.ndarray, mode: str, **kwargs) -> bytes:
    """PIL's JPEG of the BGR ``img`` converted to ``mode``."""
    buf = io.BytesIO()
    Image.fromarray(cv2.cvtColor(img, cv2.COLOR_BGR2RGB)).convert(mode).save(buf, format="JPEG",
                                                                             **kwargs)
    return buf.getvalue()


def _ycck(cmyk: bytes) -> bytes:
    """A CMYK file whose Adobe transform byte (offset 11 of the APP14 body)
    says YCCK."""
    out = bytearray(cmyk)
    out[cmyk.index(b"Adobe") + 11] = 2
    return bytes(out)


def _ycc(img: np.ndarray) -> list[np.ndarray]:
    """The Y, Cb and Cr planes of the BGR ``img``."""
    ycc = cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb)
    return [ycc[..., 0], ycc[..., 2], ycc[..., 1]]


def form_fixtures() -> dict[str, bytes]:
    """One file of each form cv2 reads and, beside them, forms it refuses."""
    small = picture(37, 53, 8)
    big = picture(480, 640, 0)
    planes = _ycc(small)
    rgb = [small[..., 2], small[..., 1], small[..., 0]]
    s420 = [(1, 2, 2), (2, 1, 1), (3, 1, 1)]
    arith = write_jpeg(_ycc(picture(96, 128, 9)), s420, coding="arith", mode="progressive",
                       markers=jfif())
    sof5 = bytearray(encode(small, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420))
    sof5[sof5.index(b"\xff\xc0") + 1] = 0xC5
    return {
        "form_411_37x53": encode(small, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, rst=3),
        "form_440_37x53_prog": encode(small, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                                      progressive=True),
        "form_cmyk_37x53": _pil(small, "CMYK", quality=90),
        "form_ycck_37x53_prog": _ycck(_pil(small, "CMYK", quality=90, progressive=True)),
        "form_rgb_37x53": _pil(small, "RGB", quality=90, keep_rgb=True),
        "form_arith_37x53_420_rst": write_jpeg(planes, s420, coding="arith", restart=3,
                                               markers=jfif()),
        "form_arith_prog_37x53_422_dac": write_jpeg(
            planes, [(1, 2, 1), (2, 1, 1), (3, 1, 1)], coding="arith", mode="progressive",
            dac=bytes([0, 0x52, 1, 0x31, 16, 2, 17, 9]), markers=jfif()),
        "form_arith_prog_96x128_cut": arith[:len(arith) * 3 // 5],
        "form_luma_up_37x53": write_jpeg(planes, [(1, 1, 1), (2, 2, 2), (3, 2, 2)],
                                         markers=jfif()),
        "form_h4v2_37x53": write_jpeg(planes, [(1, 4, 2), (2, 1, 1), (3, 1, 1)], markers=jfif()),
        "form_lossless_rgb_37x53": write_jpeg(rgb, [(1, 1, 1), (2, 1, 1), (3, 1, 1)],
                                              mode="lossless", predictor=5, restart=53),
        "form_frac_37x53": write_jpeg(planes, [(1, 3, 1), (2, 2, 1), (3, 2, 1)], markers=jfif()),
        "form_12bit_37x53": write_jpeg([planes[0].astype(np.uint16) * 16], [(1, 1, 1)],
                                       precision=12),
        "form_sof5_37x53": bytes(sof5),
        "form_cmyk_480x640_q95": _pil(big, "CMYK", quality=95),
        "form_arith_480x640_420": write_jpeg(_ycc(big), s420, coding="arith", quality=95,
                                             markers=jfif()),
    }


def c6_fixtures() -> dict[str, bytes]:
    """Files whose end ``cv2.imread`` and ``cv2.imdecode`` read apart."""
    img = picture(48, 64, 10)
    base = encode(img, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    prog = encode(img, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, progressive=True)
    rst = encode(img, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, rst=4)
    return {
        "c6_base_cut1": base[:-1],
        "c6_prog_cut1": prog[:-1],
        "c6_base_cut40": base[:-40],
        "c6_base_eoi_zeros": base[:-2] + bytes(10),
        "c6_prog_eoi_zeros": prog[:-2] + bytes(10),
        "c6_rst_stuffed_end": rst[:-1] + b"\x00",
        "c6_base_trailing_zeros": base + bytes(10),
    }


def encoder_sources() -> dict[str, np.ndarray]:
    """The pixels (RGB or gray) of the encoder's fixtures."""
    rng = np.random.default_rng(5)
    big = cv2.imread(os.path.join(HERE, "base_480x640_420_q95.jpg"), cv2.IMREAD_COLOR)
    return {
        "enc_480x640_rgb": cv2.cvtColor(big, cv2.COLOR_BGR2RGB),
        "enc_37x53_rgb_random": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "enc_17x9_rgb": cv2.cvtColor(picture(17, 9, 6), cv2.COLOR_BGR2RGB),
        "enc_1x1_rgb": rng.integers(0, 256, (1, 1, 3), dtype=np.uint8),
        "enc_96x128_gray": cv2.cvtColor(picture(96, 128, 7), cv2.COLOR_BGR2GRAY),
        "enc_33x31_gray_random": rng.integers(0, 256, (33, 31), dtype=np.uint8),
    }


def save(name: str, data: bytes, imdecode: bool = False, **arrays) -> None:
    """The file and, beside it, cv2's decode in each read mode it decodes
    (``imdecode``: also of the bytes, as ``decode_<mode>``)."""
    path = os.path.join(HERE, name + ".jpg")
    with open(path, "wb") as f:
        f.write(data)
    color, gray = cv2.imread(path, cv2.IMREAD_COLOR), cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    modes = {}
    if color is not None:
        modes["color"] = cv2.cvtColor(color, cv2.COLOR_BGR2RGB)
    if gray is not None:
        modes["gray"] = gray
    if imdecode:
        buf = np.frombuffer(data, np.uint8)
        color, gray = cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        if color is not None:
            modes["decode_color"] = cv2.cvtColor(color, cv2.COLOR_BGR2RGB)
        if gray is not None:
            modes["decode_gray"] = gray
    np.savez_compressed(os.path.join(HERE, name + ".npz"), **modes, **arrays)
    print(f"{name}: {len(data)} bytes, modes {sorted(modes)}")


def main() -> None:
    for name, data in c6_fixtures().items():
        save(name, data, imdecode=True)
    if sys.argv[1:] == ["--c6"]:
        return
    for name, data in {**fixtures(), **form_fixtures()}.items():
        save(name, data)
    for name, pixels in encoder_sources().items():
        bgr = pixels if pixels.ndim == 2 else cv2.cvtColor(pixels, cv2.COLOR_RGB2BGR)
        ok, data = cv2.imencode(".jpg", bgr)
        assert ok
        save(name, data.tobytes(), pixels=pixels)


if __name__ == "__main__":
    main()

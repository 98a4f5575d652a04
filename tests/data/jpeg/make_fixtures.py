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

The encoder's fixtures ``enc_<name>.jpg`` are ``cv2.imencode(".jpg")`` with
cv2's default parameters (quality 95, 4:2:0) of the pixels stored beside
them as ``pixels`` in ``enc_<name>.npz`` (RGB, or gray): a 480 x 640 image
(the decode of ``base_480x640_420_q95.jpg``), random and smooth small ones,
gray ones.  ``tests/test_torch_port_jpeg_encode.py`` holds them against cv2
and the port's encoder; ``chip_smoke.py`` holds the port's encoder against
them on the card's machine.
"""
import os
import struct

import cv2
import numpy as np

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


def save(name: str, data: bytes, **arrays) -> None:
    path = os.path.join(HERE, name + ".jpg")
    with open(path, "wb") as f:
        f.write(data)
    color = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(HERE, name + ".npz"), color=color,
                        gray=cv2.imread(path, cv2.IMREAD_GRAYSCALE), **arrays)
    print(f"{name}: {len(data)} bytes, {color.shape}")


def main() -> None:
    for name, data in fixtures().items():
        save(name, data)
    for name, pixels in encoder_sources().items():
        bgr = pixels if pixels.ndim == 2 else cv2.cvtColor(pixels, cv2.COLOR_RGB2BGR)
        ok, data = cv2.imencode(".jpg", bgr)
        assert ok
        save(name, data.tobytes(), pixels=pixels)


if __name__ == "__main__":
    main()

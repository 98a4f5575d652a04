"""Write the fixtures of the port's small image decoders, with cv2's decodes
beside them.

    python tests/data/imread/make_fixtures.py

Each image file (PNM P1-P6, PAM, PFM, Sun raster, Radiance HDR, GIF, RLE8 /
RLE4 BMP) is written by ``cv2.imencode`` where cv2 writes the form, or
field by field by the writers of ``tests/test_torch_port_image_forms.py``
where it does not, from seeded pixels: a 480 x 640 GIF and HDR (the sizes
a dataset holds, timed by ``chip_smoke.py``) and small files of every other
form (not the PAM *_ALPHA forms, whose colour decode cv2 leaves partly
unwritten).  ``<file>.npz`` holds what ``cv2.imread`` gives for it: ``color``
(RGB, as the readers convert it) and ``gray``, each only where cv2 decodes
it (a PFM read in the other mode is None).
``tests/test_torch_port_image_forms.py`` holds the stored arrays against
cv2 and the port; ``chip_smoke.py`` holds the port against them on a
machine without cv2.
"""
import glob
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, os.path.join(HERE, "..", "..", ".."))

import test_torch_port_image_forms as forms  # noqa: E402  (the tests' writers)

#: the files chip_smoke.py times, 480 x 640
TIMED = ("screen_480x640.gif", "rle_480x640.hdr")


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth RGB shading with a few discs: float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(x / 53 + y / 71), 0.5 + 0.4 * np.cos(x / 37 - y / 45),
                    0.2 + 0.6 * x / w], axis=-1)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(0.05, 0.3) * min(h, w)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 1, 3)
    return img.astype(np.float32)


def encode(ext: str, img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


def fixtures() -> dict[str, bytes]:
    rng = np.random.default_rng(16)
    big = scene(480, 640, 0)
    small = scene(37, 53, 1)
    small8 = (small * 255).astype(np.uint8)[..., ::-1].copy()  # BGR for cv2's writers
    gray8 = cv2.cvtColor(small8, cv2.COLOR_BGR2GRAY)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    idx = (small[..., 0] * 15.99).astype(np.uint8)
    big_idx = (big[..., 0] * 7.99).astype(np.uint8) * 32 + (big[..., 1] * 31.99).astype(np.uint8)
    big_pal = np.stack(np.meshgrid(np.arange(8) * 36, np.arange(32) * 8, indexing="ij"), -1)
    big_pal = np.concatenate([big_pal.reshape(256, 2), np.full((256, 1), 128)], 1).astype(np.uint8)
    rgbe = forms._rgbe(rng, 48, 40)
    rle4 = forms._rle_stream(np.random.default_rng(4), 17, 6, 4)
    rle8 = forms._rle_stream(np.random.default_rng(8), 23, 9, 8)
    bits = (small[..., 1] > 0.5).astype(np.uint8)
    return {
        # PNM: cv2's binary and ASCII files, then hand-built forms
        "p5_37x53.pgm": encode(".pgm", gray8),
        "p6_37x53.ppm": encode(".ppm", small8),
        "p4_37x53.pbm": encode(".pbm", gray8),
        "p2_37x53_ascii.pgm": encode(".pgm", gray8, (cv2.IMWRITE_PXM_BINARY, 0)),
        "p3_37x53_ascii.ppm": encode(".ppm", small8, (cv2.IMWRITE_PXM_BINARY, 0)),
        "p1_11x7.pbm": forms._pnm(1, 11, 7, 1, bits[:7, :11]),
        "p2_max100_9x5.pgm": forms._pnm(2, 9, 5, 100, rng.integers(0, 120, (5, 9))),
        "p6_16bit_9x5.ppm": forms._pnm(6, 9, 5, 65535, rng.integers(0, 65536, (5, 9, 3))),
        # PAM: cv2's files and the tuple types
        "gray_37x53.pam": encode(".pam", gray8),
        "rgb_37x53.pam": encode(".pam", small8),
        "bw_16x3.pam": forms._pam(16, 3, 1, 1, b"BLACKANDWHITE", rng.integers(0, 256, (3, 16, 1))),
        # PFM: colour and gray, both byte orders
        "rgb_37x53.pfm": encode(".pfm", small[..., ::-1].copy() * 255),
        "gray_be_9x5.pfm": forms._pfm(rng.uniform(-20, 300, (5, 9)).astype(np.float32), 2.0),
        # Sun raster: cv2's 8- and 24-bit files, a colour map, 1 and 32 bits
        "rgb_37x53.ras": encode(".ras", small8),
        "map8_13x5.ras": forms._ras(13, 5, 8, 1, rng.integers(0, 256, (5, 13), dtype=np.uint8),
                                    rng.integers(0, 256, 768, dtype=np.uint8).tobytes()),
        "bits_21x4.ras": forms._ras(21, 4, 1, 1, rng.integers(0, 256, (4, 3), dtype=np.uint8)),
        "xbgr_7x3.ras": forms._ras(7, 3, 32, 0, rng.integers(0, 256, (3, 28), dtype=np.uint8)),
        # Radiance HDR: cv2's RLE files (the timed one), flat scanlines
        "rle_480x640.hdr": encode(".hdr", big[..., ::-1].copy() * 2),
        "rle_37x53.hdr": encode(".hdr", small[..., ::-1].copy() * 4),
        "flat_48x40.hdr": b"#?RADIANCE\n" + forms._HDR_FORMAT + b"\n-Y 48 +X 40\n" + rgbe.tobytes(),
        # GIF: the timed 480 x 640 screen, interlace, transparency, a small frame
        "screen_480x640.gif": forms._gif((640, 480), [dict(idx=big_idx, min_size=8)], gpal=big_pal),
        "interlaced_37x53.gif": forms._gif((53, 37), [dict(idx=idx, min_size=4, interlace=True)],
                                           gpal=pal),
        "frame_on_screen_37x53.gif": forms._gif(
            (53, 37), [dict(idx=idx[5:30, 7:40], min_size=4, left=7, top=5, transparent=3,
                            lpal=pal[::-1])], gpal=pal, bg=2),
        "cv2_37x53.gif": encode(".gif", small8),
        # BMP RLE8 and RLE4
        "rle8_23x9.bmp": forms._rle_bmp(23, 9, 8, rle8, rng.integers(0, 256, (256, 3))),
        "rle4_17x6.bmp": forms._rle_bmp(17, 6, 4, rle4, rng.integers(0, 256, (16, 3))),
    }


def main() -> None:
    for path in glob.glob(os.path.join(HERE, "*")):
        if not path.endswith(".py"):
            os.remove(path)
    for name, data in fixtures().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        arrays = {}
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            got = cv2.imread(path, flag)
            if got is not None:
                arrays[mode] = got[..., ::-1] if got.ndim == 3 else got
        assert arrays, name
        np.savez_compressed(path + ".npz", **arrays)
        print(f"{name}: {len(data)} bytes, {sorted(arrays)}")


if __name__ == "__main__":
    main()

"""Write the TIFF fixtures of the port's TIFF decoder, with cv2's decodes
beside them.

    python tests/data/tiff/make_fixtures.py

Each ``<name>.tif`` is written by ``cv2.imencode``, PIL, ``tiff_writer.py``
(the tests' writer of the forms neither writes) or ``libtiff_writer.py``
(the system's libtiff through ctypes: SGILog and 16-bit CIELab) from seeded
pixels: five 480 x 640 files of a smooth picture (the size a dataset
holds, timed by ``chip_smoke.py``: cv2's LZW, Deflate with the horizontal
predictor, JPEG 4:2:0 strips with their tables in JPEGTables, 8-bit CIELab
with Deflate, LogLuv24 over five decades of luminance) and small files of
the other forms (byte orders, BigTIFF, PackBits, old-style LZW, FillOrder
2, tiles, planar configuration 2, 1-, 4-, 8- and 16-bit samples,
MinIsWhite, palettes, alpha, CMYK, subsampled YCbCr, CIELab at 8 and 16
bits with and without a WhitePoint, LogL, LogLuv32 and LogLuv24,
orientations 2-8, CCITT RLE, RLEW at even and odd offsets, Group 3 and
Group 4, their strips with damaged EOLs, ThunderScan, a file cut in its
directory).

``<name>.npz`` holds what cv2 gives for it, RGB as the readers convert it:
``color`` and ``gray`` from ``cv2.imread`` of the file, each only where cv2
decodes; ``decode_same`` where ``cv2.imdecode`` of its bytes gives the same,
else ``decode_color`` and ``decode_gray`` where it decodes (the two differ on
orientations 5-8 and small uncompressed tiles).  The 480 x 640 decodes are
stored as ``<key>_sha256`` (the SHA-256 of the array's bytes) and
``<key>_shape``, so that the fixtures stay small.
``tests/test_torch_port_tiff.py`` holds the stored arrays against cv2 and
the port; ``chip_smoke.py`` holds the port against them on a machine
without cv2.
"""
import glob
import hashlib
import io
import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import libtiff_writer as lw  # noqa: E402
import tiff_writer as tw  # noqa: E402

#: the files chip_smoke.py times, 480 x 640
TIMED = ("lzw_480x640.tif", "deflate_480x640.tif", "jpeg_480x640.tif", "cielab8_480x640.tif",
         "logluv24_480x640.tif")
#: arrays larger than this are stored as their SHA-256
BIG = 200_000


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """An RGB image of smooth shading and a few flat discs (small when
    compressed)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([96 + 60 * np.sin(x / 53 + y / 71), 128 + 50 * np.cos(x / 37 - y / 45),
                    40 + 0.2 * x + 0.15 * y], axis=-1)
    for _ in range(3):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.1, 0.3) * min(h, w)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_strip(part: np.ndarray, quality: int = 90) -> bytes:
    """cv2's 4:2:0 JPEG of an RGB strip, its tables taken out."""
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(part[..., ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    return tw.split_jpeg_tables(buf.tobytes())[1]


def pil(img: np.ndarray, mode: str, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="TIFF", **kwargs)
    return buf.getvalue()


def lab_of(rgb: np.ndarray, bits: int = 8) -> np.ndarray:
    """CIELab samples [h, w, 3] standing for an RGB picture (L its mean,
    a and b its red-green and blue-yellow differences), as the file stores
    them: L unsigned, a and b two's complement in ``bits`` bits."""
    v = rgb.astype(np.int64)
    lab = np.stack([v.mean(axis=2).astype(np.int64), (v[..., 0] - v[..., 1]) // 2,
                    (v[..., 1] - v[..., 2]) // 2], axis=-1)
    if bits == 16:
        lab = lab * np.array([257, 256, 256])
    return lab & ((1 << bits) - 1)


def xyz_of(rgb: np.ndarray, exposure: np.ndarray) -> np.ndarray:
    """Float XYZ [h, w, 3] of a wide dynamic range standing for an RGB
    picture: its linear values through CCIR-709's matrix, times
    ``exposure`` (a factor per pixel spanning decades)."""
    lin = (rgb.astype(np.float64) / 255.0) ** 2.2
    m = np.array([[0.4124, 0.3576, 0.1805], [0.2126, 0.7152, 0.0722], [0.0193, 0.1192, 0.9505]])
    return (lin @ m.T * exposure[..., None]).astype(np.float32)


def damaged(data: bytes, zeros: tuple, ones: tuple = ()) -> bytes:
    """``data`` (whose first strip starts at byte 8) with the strip's bytes
    at ``zeros`` set to 0 and at ``ones`` to 0xFF: codes lost, and an EOL
    lost late in the strip, where libtiff then reads the strip again
    without EOLs."""
    out = bytearray(data)
    for at in zeros:
        out[8 + at] = 0
    for at in ones:
        out[8 + at] = 0xFF
    return bytes(out)


def fixtures() -> dict[str, bytes]:
    big = picture(480, 640, 0)
    a = picture(37, 53, 1)
    rng = np.random.default_rng(2)
    noisy = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255)
    gray = noisy[..., :1]
    bits = (rng.random((37, 53, 1)) < 0.3).astype(int)
    pal = rng.integers(0, 65536, (256, 3))
    ok, lzw_big = cv2.imencode(".tiff", big[..., ::-1])
    tables = tw.split_jpeg_tables(cv2.imencode(".jpg", big[..., ::-1],
                                               [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes())[0]
    out = {
        "lzw_480x640": lzw_big.tobytes(),
        "deflate_480x640": tw.write_tiff(big, photometric=2, compression=tw.DEFLATE, predictor=2,
                                         rows_per_strip=16),
        "jpeg_480x640": tw.write_tiff(big, photometric=6, subsampling=(2, 2),
                                      compression=tw.JPEG, rows_per_strip=16,
                                      jpeg_strip=jpeg_strip, jpeg_tables=tables),
        "rgb_packbits_be": tw.write_tiff(noisy, photometric=2, compression=tw.PACKBITS,
                                         order=">", rows_per_strip=8),
        "rgb_bigtiff_be_lzw": tw.write_tiff(noisy, photometric=2, compression=tw.LZW, order=">",
                                            big=True, rows_per_strip=8),
        "rgb_old_lzw": tw.write_tiff(noisy, photometric=2, compression=tw.LZW, lzw_old=True),
        "rgb_fill2_deflate": tw.write_tiff(noisy, photometric=2, compression=tw.DEFLATE,
                                           fillorder=2, rows_per_strip=8),
        "rgb16_pred_be": tw.write_tiff(noisy.astype(int) * 257 + 3, bps=16, photometric=2,
                                       compression=tw.DEFLATE, predictor=2, order=">"),
        "rgba_unassoc": tw.write_tiff(np.concatenate([noisy, gray], axis=2), photometric=2,
                                      extra_samples=(2,)),
        "rgba16_unassoc_planar": tw.write_tiff(
            np.concatenate([noisy, gray], axis=2).astype(int) * 257, bps=16, photometric=2,
            planar=2, extra_samples=(2,)),
        "rgb_planar_tiles": tw.write_tiff(noisy, photometric=2, planar=2, tile=(16, 16),
                                          compression=tw.LZW),
        "rgb_tiles_32": tw.write_tiff(noisy, photometric=2, tile=(32, 32)),
        "rgb_tiles_16": tw.write_tiff(noisy, photometric=2, tile=(16, 16)),
        "gray16_minwhite": tw.write_tiff(gray.astype(int) * 251, bps=16, photometric=0),
        "gray8_alpha_tiles": tw.write_tiff(np.concatenate([gray, gray[::-1]], axis=2),
                                           photometric=1, extra_samples=(2,), tile=(16, 16),
                                           compression=tw.LZW),
        "bilevel_minwhite": tw.write_tiff(bits, bps=1, photometric=0, rows_per_strip=5),
        "palette8": tw.write_tiff(gray, photometric=3, colormap=pal),
        "palette4_tiles": tw.write_tiff(gray % 16, bps=4, photometric=3, colormap=pal[:16],
                                        tile=(16, 16), compression=tw.PACKBITS),
        "palette1_8bitmap": tw.write_tiff(bits, bps=1, photometric=3,
                                          colormap=np.array([[0, 0, 0], [200, 100, 50]])),
        "cmyk": tw.write_tiff(np.concatenate([noisy, gray], axis=2), photometric=5),
        "cmyk_planar": tw.write_tiff(np.concatenate([noisy, gray], axis=2), photometric=5,
                                     planar=2),
        "ycbcr_420": tw.write_tiff(noisy, photometric=6, subsampling=(2, 2), rows_per_strip=8),
        "ycbcr_44_tiles": tw.write_tiff(noisy, photometric=6, subsampling=(4, 4), tile=(16, 16),
                                        compression=tw.LZW),
        "jpeg_gray": pil(a, "L", compression="jpeg"),
        "jpeg_rgb_pil": pil(a, "RGB", compression="jpeg"),
        "ccitt_rle": pil(bits[..., 0].astype(np.uint8) * 255, "1", compression="tiff_ccitt"),
        "ccitt_g3_2d": pil(bits[..., 0].astype(np.uint8) * 255, "1", compression="group3",
                           tiffinfo={292: 5}),
        "ccitt_g4": pil(bits[..., 0].astype(np.uint8) * 255, "1", compression="group4"),
        "thunderscan": tw.write_tiff(gray % 16, bps=4, photometric=3, colormap=pal[:16],
                                     compression=tw.JPEG, extra_tags={259: ("H", [32809])},
                                     jpeg_strip=lambda p: bytes(0xC0 | int(v) for v in p.ravel())),
        "gray2_refused": tw.write_tiff(gray % 4, bps=2, photometric=1),
        "cut_directory": tw.write_tiff(noisy, photometric=2, compression=tw.LZW)[:-20],
    }
    # CIELab, SGILog and CCITT RLEW; CCITT strips with damaged EOLs
    y, x = np.mgrid[0:480, 0:640]
    wide = 10.0 ** (-3 + 5 * x / 639)  # five decades across the picture
    small_wide = 10.0 ** (-4 + 6 * np.mgrid[0:37, 0:53][1] / 52)
    xyz = xyz_of(noisy, small_wide)
    bits2d = bits[..., 0].astype(np.uint8) * 255
    out.update({
        "cielab8_480x640": tw.write_tiff(lab_of(big), photometric=8, compression=tw.DEFLATE,
                                         predictor=2, rows_per_strip=16),
        "logluv24_480x640": lw.sgilog(xyz_of(big, wide), lw.SGILOG24, rows_per_strip=16),
        "cielab8_pil": pil(noisy.astype(np.uint8), "LAB"),
        "cielab8_whitepoint": lw.cielab(lab_of(noisy), whitepoint=(0.3127, 0.3290)),
        "cielab16": lw.cielab(lab_of(noisy, 16), bps=16, rows_per_strip=8),
        "cielab16_be_tiles": tw.write_tiff(lab_of(noisy, 16), bps=16, photometric=8, order=">",
                                           tile=(16, 16), compression=tw.LZW),
        "logl": lw.sgilog(xyz[..., 1], rows_per_strip=8),
        "logluv32": lw.sgilog(xyz, rows_per_strip=8),
        "logluv24": lw.sgilog(xyz, lw.SGILOG24),
        "ccitt_rlew_even": tw.write_tiff(bits, bps=1, photometric=0, compression=tw.JPEG,
                                         rows_per_strip=8, jpeg_strip=tw.ccitt_rlew,
                                         extra_tags={259: ("H", [32771])}),
        "ccitt_rlew_odd": tw.write_tiff(bits, bps=1, photometric=0, compression=tw.JPEG,
                                        rows_per_strip=8, jpeg_strip=tw.ccitt_rlew,
                                        extra_tags={259: ("H", [32771])}, lead=1),
        "ccitt_g3_1d_damaged": damaged(pil(bits2d, "1", compression="group3"), (60, 61, 150),
                                       (439, 440)),
        "ccitt_g3_2d_damaged": damaged(pil(bits2d, "1", compression="group3", tiffinfo={292: 1}),
                                       (40, 41, 90), (489, 490)),
        "ccitt_g4_damaged": damaged(pil(bits2d, "1", compression="group4"), (30, 31)),
    })
    for o in range(2, 9):
        out[f"orient{o}"] = tw.write_tiff(noisy, photometric=2, orientation=o, rows_per_strip=8,
                                          compression=tw.LZW)
    out["orient6_tiles"] = tw.write_tiff(noisy, photometric=2, orientation=6, tile=(16, 16),
                                         compression=tw.LZW)
    return out


def cv2_reads(path: str, data: bytes) -> dict:
    """cv2's decodes of the file and (where they differ) of its bytes, RGB,
    where it decodes."""
    reads = {}
    for key, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        for prefix, img in (("", cv2.imread(path, flag)),
                            ("decode_", cv2.imdecode(np.frombuffer(data, np.uint8), flag))):
            reads[prefix + key] = None if img is None else img[..., ::-1] if img.ndim == 3 else img
    same = all((reads[k] is None and reads["decode_" + k] is None) or (
        reads[k] is not None and reads["decode_" + k] is not None
        and np.array_equal(reads[k], reads["decode_" + k])) for k in ("color", "gray"))
    out = {}
    for k, v in reads.items():
        if v is None or (same and k[0] == "d"):
            continue
        if v.size > BIG:
            out[k + "_sha256"] = np.array(hashlib.sha256(np.ascontiguousarray(v)).hexdigest())
            out[k + "_shape"] = np.array(v.shape)
        else:
            out[k] = v
    if same:
        out["decode_same"] = np.ones(1, bool)
    return out


def matches(stored, mode: str, imdecode: bool, got) -> bool:
    """Whether a read (an array, or None where it raised) is the stored cv2
    result of the file (``imdecode``: of its bytes) in ``mode``."""
    key = ("decode_" + mode) if imdecode and "decode_same" not in stored else mode
    if key + "_sha256" in stored:
        return got is not None and tuple(got.shape) == tuple(stored[key + "_shape"]) and \
            hashlib.sha256(np.ascontiguousarray(got)).hexdigest() == str(stored[key + "_sha256"])
    if key in stored:
        return got is not None and got.shape == stored[key].shape and \
            np.array_equal(got, stored[key])
    return got is None


def main() -> None:
    for old in glob.glob(os.path.join(HERE, "*.tif")) + glob.glob(os.path.join(HERE, "*.npz")):
        os.remove(old)
    for name, data in fixtures().items():
        path = os.path.join(HERE, name + ".tif")
        with open(path, "wb") as f:
            f.write(data)
        arrays = cv2_reads(path, data)
        np.savez_compressed(os.path.join(HERE, name + ".npz"), **arrays)
        print(f"{name}: {len(data)} bytes, {sorted(arrays)}")


if __name__ == "__main__":
    main()

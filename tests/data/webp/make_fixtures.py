"""Write the WebP fixtures of the port's WebP decoder, with cv2's decodes
beside them.

    python tests/data/webp/make_fixtures.py

Each ``<name>.webp`` is written by ``cv2.imencode``, PIL or ``webp_writer.c``
(the tests' writer of the settings neither exposes, built here with gcc
against the system's libwebp), or assembled from their chunks, from seeded
pixels: lossy files at qualities 1-100; both loop filters, filter strength
0, sharpness 0 and 7; 1, 2, 4 and 8 token partitions; 1-4 segments; odd
sides (1 x 1, 17 x 33); lossless files of every method, near-lossless, and
palettes of 2, 4, 16 and 256 colours; ALPH chunks of method 0 and 1 with
each of the four filters, and libwebp's own; VP8X files with EXIF
orientations 1-8 and with ICCP; animations whose first frame has an offset
(lossless, and lossy with ALPH, each blend and dispose setting); files cv2
refuses (``refused_*``: a bad alpha stream, lossy and lossless streams that
end early, a corrupt first frame, a 31-byte header); the three
480 x 640 files ``chip_smoke.py`` times (lossy q75, lossy q90, lossless);
and ``coco_00.webp`` ... ``coco_31.webp``, 480 x 640 scenes of two people
each (even numbers lossy, odd lossless), whose people ``coco_scenes.json``
lists as (cx, cy, ax, ay) ellipses, for the WebP COCO tree of the tests and
of ``chip_smoke.py``.

``<name>.npz`` holds what cv2 gives for it, RGB as the readers convert it:
``color`` and ``gray`` from ``cv2.imread`` of the file, each only where cv2
decodes; ``decode_same`` where ``cv2.imdecode`` of its bytes gives the
same, else ``decode_color`` and ``decode_gray``.  Arrays of more than
``BIG`` bytes are stored as ``<key>_sha256`` and ``<key>_shape``.
``tests/test_torch_port_webp.py`` holds the stored arrays against cv2 and
the port; ``chip_smoke.py`` holds the port against them on a machine
without cv2.
"""
import glob
import hashlib
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
#: the files chip_smoke.py times, 480 x 640
TIMED = ("lossy_q75_480x640.webp", "lossy_q90_480x640.webp", "lossless_480x640.webp")
#: the COCO scenes: count, size, people per scene
COCO_SCENES, COCO_HW, COCO_PEOPLE = 32, (480, 640), 2
#: arrays larger than this are stored as their SHA-256
BIG = 200_000


def picture(h: int, w: int, seed: int, noise: int = 0) -> np.ndarray:
    """An RGB image of smooth shading and a few flat discs, plus uniform
    noise of +-``noise``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([96 + 60 * np.sin(x / 53 + y / 71), 128 + 50 * np.cos(x / 37 - y / 45),
                    40 + 0.2 * x + 0.15 * y], axis=-1)
    for _ in range(3):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.1, 0.3) * min(h, w)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    if noise:
        img += rng.integers(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def scene(seed: int) -> tuple[np.ndarray, list]:
    """A 480 x 640 RGB scene: linear shading with ``COCO_PEOPLE`` brighter
    ellipses side by side, and each one's (cx, cy, ax, ay)."""
    rng = np.random.default_rng(1000 + seed)
    h, w = COCO_HW
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([30 + xx // 8, 40 + yy // 6, 60 + (xx + yy) // 16], axis=-1) + seed
    people = []
    for k in range(COCO_PEOPLE):
        cx = float(np.round(rng.uniform(0.15, 0.35) * w + k * w / 2, 1))
        cy, ax, ay = (float(np.round(v, 1)) for v in (rng.uniform(0.35, 0.65) * h,
                                                       rng.uniform(50, 90), rng.uniform(110, 160)))
        inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
        img[inside] += 110
        people.append([cx, cy, ax, ay])
    return np.clip(img, 0, 255).astype(np.uint8), people


def cv2_webp(rgb: np.ndarray, quality: int) -> bytes:
    bgr = rgb[..., [2, 1, 0, 3][:rgb.shape[2]]]
    ok, buf = cv2.imencode(".webp", np.ascontiguousarray(bgr),
                           [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


def pil_webp(img: np.ndarray, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kwargs)
    return buf.getvalue()


class Writer:
    """``webp_writer.c``, built with gcc against the system's libwebp."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.exe = os.path.join(tmp, "webp_writer")
        subprocess.run(["gcc", "-O2", os.path.join(HERE, "webp_writer.c"), "-lwebp", "-o",
                        self.exe], check=True)

    def __call__(self, img: np.ndarray, **settings) -> bytes:
        raw, out = os.path.join(self.tmp, "in.raw"), os.path.join(self.tmp, "out.webp")
        np.ascontiguousarray(img).tofile(raw)
        h, w, c = img.shape
        subprocess.run([self.exe, raw, str(w), str(h), str(c), out]
                       + [f"{k}={v}" for k, v in settings.items()], check=True)
        with open(out, "rb") as f:
            return f.read()


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(chunks) -> bytes:
    body = b"".join(chunk(t, p) for t, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def chunks_of(data: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def vp8x(flags: int, w: int, h: int) -> tuple:
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")


def anmf(x: int, y: int, w: int, h: int, bits: int, frame_chunks) -> tuple:
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100))
    return b"ANMF", head + bytes([bits]) + b"".join(chunk(t, p) for t, p in frame_chunks)


def exif(orientation: int, little: bool = False) -> bytes:
    """A TIFF block whose IFD0 holds the orientation (the EXIF chunk's
    payload, without the ``Exif\\0\\0`` prefix)."""
    e = "<" if little else ">"
    return (b"II*\0" if little else b"MM\0*") + struct.pack(e + "IHHHIHH", 8, 1, 0x0112, 3, 1,
                                                              orientation, 0) + bytes(4)


def fit_sizes(data: bytes) -> bytes:
    """``data`` (a WebP cut short) with its RIFF size, and the size of the
    chunk it ends in, cut to fit: the decoders then run out of data."""
    data = bytearray(data)
    if len(data) >= 8:
        data[4:8] = struct.pack("<I", len(data) - 8)
    pos = 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > len(data):
            data[pos + 4:pos + 8] = struct.pack("<I", len(data) - pos - 8)
            break
        pos += 8 + size + (size & 1)
    return bytes(data)


def filtered(alpha: np.ndarray, method: int) -> np.ndarray:
    """The ALPH forward filter (0 none, 1 horizontal, 2 vertical, 3
    gradient) that libwebp's decoder undoes."""
    a = alpha.astype(np.int32)
    out = a.copy()
    h, w = a.shape
    for y in range(h):
        for x in range(w):
            if method == 0:
                pred = 0
            elif y == 0:
                pred = a[0, x - 1] if x else 0
            elif method == 1 or (method == 3 and x == 0):
                pred = a[y, x - 1] if x else a[y - 1, 0]
            elif method == 2:
                pred = a[y - 1, x]
            else:
                pred = min(max(a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1], 0), 255)
            out[y, x] = a[y, x] - pred
    return (out & 0xFF).astype(np.uint8)


def alph(alpha: np.ndarray, method: int, filt: int) -> bytes:
    """An ALPH payload: raw (method 0) or a VP8L stream of the filtered
    values in green (method 1: libwebp's lossless encoding of that image,
    its 5-byte header taken off)."""
    values = filtered(alpha, filt)
    head = bytes([method | (filt << 2)])
    if method == 0:
        return head + values.tobytes()
    green = np.zeros(values.shape + (3,), np.uint8)
    green[..., 1] = values
    vp8l = dict(chunks_of(pil_webp(green, lossless=True)))[b"VP8L"]
    return head + vp8l[5:]


def fixtures() -> dict[str, bytes]:
    small = picture(40, 56, 1, noise=12)
    rgba = np.dstack([small, picture(40, 56, 2)[..., 0]])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        wr = Writer(tmp)
        for q in (1, 5, 10, 20, 30, 40, 50, 60, 70, 80, 90, 95, 100):
            out[f"lossy_q{q}"] = cv2_webp(small, q)
        for ftype in (0, 1):
            for sharp in (0, 7):
                out[f"filter{ftype}_sharp{sharp}"] = wr(small, quality=60, filter_type=ftype,
                                                        filter_sharpness=sharp, filter_strength=80,
                                                        autofilter=0)
        out["filter_strength0"] = wr(small, quality=60, filter_strength=0)
        for p in range(4):
            out[f"partitions{1 << p}"] = wr(picture(72, 88, 3, noise=20), quality=70, partitions=p)
        for s in (1, 2, 3, 4):
            out[f"segments{s}"] = wr(small, quality=50, segments=s, sns_strength=100)
        for h, w in ((1, 1), (17, 33)):
            odd = picture(h, w, 4, noise=30)
            out[f"lossy_{h}x{w}"] = cv2_webp(odd, 80)
            out[f"lossless_{h}x{w}"] = cv2_webp(odd, 101)
        for m in range(7):
            out[f"lossless_method{m}"] = wr(small, lossless=1, method=m, quality=75)
        out["near_lossless60"] = wr(small, lossless=1, near_lossless=60)
        rng = np.random.default_rng(5)
        for n in (2, 4, 16, 256):
            pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            out[f"palette{n}"] = cv2_webp(pal[rng.integers(0, n, (40, 56))], 101)
        for method in (0, 1):
            for filt in range(4):
                vp8 = dict(chunks_of(cv2_webp(small, 80)))[b"VP8 "]
                out[f"alph_m{method}_f{filt}"] = riff([vp8x(0x10, 56, 40),
                                                       (b"ALPH", alph(rgba[..., 3], method, filt)),
                                                       (b"VP8 ", vp8)])
        for comp in (0, 1):
            for filt in (0, 1, 2):
                out[f"alpha_libwebp_c{comp}_f{filt}"] = wr(rgba, quality=70, alpha_compression=comp,
                                                           alpha_filtering=filt)
        out["alpha_rgba_pil"] = pil_webp(rgba, quality=80)
        out["lossless_rgba"] = cv2_webp(rgba, 101)
        out["lossy_rgba_cv2"] = cv2_webp(rgba, 85)
        odd = picture(24, 40, 6, noise=20)
        lossless, lossy = chunks_of(cv2_webp(odd, 101))[0], chunks_of(cv2_webp(odd, 80))[0]
        for o in range(1, 9):
            out[f"exif{o}_lossless"] = riff([vp8x(0x08, 40, 24), lossless, (b"EXIF", exif(o))])
            out[f"exif{o}_lossy_le"] = riff([vp8x(0x08, 40, 24), (b"EXIF", exif(o, True)), lossy])
        out["exif6_flag_unset"] = riff([vp8x(0, 40, 24), lossless, (b"EXIF", exif(6))])
        out["exif6_prefixed"] = riff([vp8x(0x08, 40, 24), lossless,
                                      (b"EXIF", b"Exif\0\0" + exif(6))])
        out["iccp"] = pil_webp(odd, quality=80, icc_profile=bytes(range(256)) * 2)
        frame = picture(16, 16, 7, noise=25)
        frame_a = np.dstack([frame, picture(16, 16, 8)[..., 1]])
        frame_lossless = chunks_of(pil_webp(frame_a, lossless=True))
        frame_lossy = [c for c in chunks_of(pil_webp(frame_a, quality=80)) if c[0] != b"VP8X"]
        for bits in range(4):
            for kind, frame_chunks in (("lossless", frame_lossless), ("lossy", frame_lossy)):
                out[f"anim_{kind}_bits{bits}"] = riff([
                    vp8x(0x12, 40, 30), (b"ANIM", bytes([30, 20, 10, 255, 0, 0])),
                    anmf(4, 6, 16, 16, bits, frame_chunks), anmf(0, 0, 16, 16, 0, frame_chunks)])
        # files cv2 refuses (None): a bad alpha stream, a lossy and a lossless
        # stream that end early, a corrupt first frame, a short header
        bad_alpha = bytearray(alph(rgba[..., 3], 1, 1))
        bad_alpha[3] ^= 0xFF
        out["refused_alph_stream"] = riff([vp8x(0x10, 56, 40), (b"ALPH", bytes(bad_alpha)),
                                           (b"VP8 ", vp8)])
        lossy_small = cv2_webp(small, 80)
        out["refused_lossy_cut"] = fit_sizes(lossy_small[:len(lossy_small) * 3 // 4])
        lossless_small = cv2_webp(small, 101)
        out["refused_lossless_cut"] = fit_sizes(lossless_small[:len(lossless_small) * 3 // 4])
        corrupt = [(b"VP8L", frame_lossless[0][1][:12] + bytes(len(frame_lossless[0][1]) - 12))]
        out["refused_anim_frame"] = riff([vp8x(0x12, 40, 30), (b"ANIM", bytes(6)),
                                          anmf(4, 6, 16, 16, 0, corrupt)])
        out["refused_short_header"] = lossless_small[:31]
        big = picture(480, 640, 9, noise=6)
        out["lossy_q75_480x640"] = cv2_webp(big, 75)
        out["lossy_q90_480x640"] = cv2_webp(big, 90)
        out["lossless_480x640"] = cv2_webp(picture(480, 640, 9, noise=2), 101)
    scenes = []
    for i in range(COCO_SCENES):
        img, people = scene(i)
        out[f"coco_{i:02d}"] = cv2_webp(img, 101 if i % 2 else (75 if i % 4 == 0 else 90))
        scenes.append(people)
    with open(os.path.join(HERE, "coco_scenes.json"), "w") as f:
        json.dump({"height": COCO_HW[0], "width": COCO_HW[1], "people": scenes}, f)
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
    if shutil.which("gcc") is None:
        raise SystemExit("make_fixtures.py builds webp_writer.c with gcc")
    for old in glob.glob(os.path.join(HERE, "*.webp")) + glob.glob(os.path.join(HERE, "*.npz")):
        os.remove(old)
    total = 0
    for name, data in fixtures().items():
        path = os.path.join(HERE, name + ".webp")
        with open(path, "wb") as f:
            f.write(data)
        arrays = cv2_reads(path, data)
        if name.startswith("refused_"):
            assert sorted(arrays) == ["decode_same"], name  # cv2 returns None
        np.savez_compressed(os.path.join(HERE, name + ".npz"), **arrays)
        total += len(data) + os.path.getsize(os.path.join(HERE, name + ".npz"))
        print(f"{name}: {len(data)} bytes, {sorted(arrays)}")
    print(f"{total} bytes in all")


if __name__ == "__main__":
    main()

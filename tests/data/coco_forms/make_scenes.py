"""Write the 480 x 640 scenes of the COCO tree that ``chip_smoke.py``'s
``tiff_phase`` trains and serves and ``tests/test_torch_port_tiff.py``
converts with both packages, with cv2's decodes beside them.

    python tests/data/coco_forms/make_scenes.py

Each scene holds two people (brighter ellipses, their ``(cx, cy, ax, ay)``
in ``coco_scenes.json``) on a shaded ground, in one of the image forms read
last: ``coco_00``-``coco_07.tif`` 8-bit CIELab and ``coco_08``-``coco_15.tif``
16-bit CIELab (Deflate with the horizontal predictor, ``tiff_writer.py``),
``coco_16``-``coco_23.tif`` LogLuv32 (SGILog over the system's libtiff,
``libtiff_writer.py``; flat bands of luminance across two decades), and
``coco_24``-``coco_31.jpg`` JPEGs whose EXIF block makes cv2 stop before
its orientation 6 entry (the stopping cases of ``tests/data/exif``), so
that cv2 reads them unturned and their people are where the scene drew
them.

``coco_NN.npz`` holds cv2's decodes as ``tests/data/tiff/make_fixtures.py``
stores its 480 x 640 files (SHA-256 and shape).
"""
import glob
import importlib.util
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.dirname(HERE)
#: count, size and people of the scenes; the form of each block of 8
SCENES, HW, PEOPLE = 32, (480, 640), 2
FORMS = ("cielab8", "cielab16", "logluv32", "jpeg_exif")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def people(seed: int) -> list:
    rng = np.random.default_rng(3000 + seed)
    h, w = HW
    out = []
    for k in range(PEOPLE):
        cx = float(np.round(rng.uniform(0.15, 0.35) * w + k * w / 2, 1))
        cy, ax, ay = (float(np.round(v, 1)) for v in (rng.uniform(0.35, 0.65) * h,
                                                       rng.uniform(50, 90), rng.uniform(110, 160)))
        out.append([cx, cy, ax, ay])
    return out


def inside(ppl: list) -> np.ndarray:
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    return np.any([((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
                   for cx, cy, ax, ay in ppl], axis=0)


def scene(i: int) -> bytes:
    tiff_dir = os.path.join(DATA, "tiff")
    tw = _load(os.path.join(tiff_dir, "tiff_writer.py"), "tiff_writer")
    lw = _load(os.path.join(tiff_dir, "libtiff_writer.py"), "libtiff_writer")
    ppl, form = people(i), FORMS[i // 8]
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    mask = inside(ppl)
    if form in ("cielab8", "cielab16"):
        L = np.where(mask, 140 + i, 30 + xx // 10 + i)
        lab = np.stack([L, (xx - 320) // 8 + i, (yy - 240) // 8 - i], -1)
        if form == "cielab16":
            return tw.write_tiff((lab * np.array([257, 256, 256])) & 0xFFFF, bps=16,
                                 photometric=8, compression=tw.DEFLATE, predictor=2,
                                 rows_per_strip=16)
        return tw.write_tiff(lab & 0xFF, photometric=8, compression=tw.DEFLATE, predictor=2,
                             rows_per_strip=16)
    if form == "logluv32":
        y = (0.01 * 1.5 ** (xx // 80)).astype(np.float32) * (1 + 0.05 * (i % 8))
        y = np.where(mask, y * 30, y)
        xyz = np.stack([y * 0.95, y, y * (0.9 + 0.05 * (i % 4))], -1).astype(np.float32)
        return lw.sgilog(xyz, rows_per_strip=16)
    exif = _load(os.path.join(DATA, "exif", "make_fixtures.py"), "exif_fixtures")
    stops = [case for case, (_, turned) in exif.CASES.items() if not turned]
    rgb = np.stack([30 + xx // 8, 40 + yy // 6, 60 + (xx + yy) // 16], axis=-1) + i
    rgb = np.clip(np.where(mask[..., None], rgb + 110, rgb), 0, 255).astype(np.uint8)
    jpeg = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                        [cv2.IMWRITE_JPEG_QUALITY, 80])[1].tobytes()
    entry = exif.CASES[stops[i % len(stops)]][0]
    return exif.jpeg_with_exif(jpeg, exif.exif_block(entry, "<>"[i % 2]))


def main() -> None:
    tiff = _load(os.path.join(DATA, "tiff", "make_fixtures.py"), "tiff_fixtures")
    for old in glob.glob(os.path.join(HERE, "coco_*")):
        os.remove(old)
    files = []
    for i in range(SCENES):
        name = f"coco_{i:02d}." + ("jpg" if FORMS[i // 8] == "jpeg_exif" else "tif")
        data = scene(i)
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        arrays = tiff.cv2_reads(path, data)
        assert arrays["color_shape"].tolist() == [*HW, 3], name  # read unturned
        np.savez_compressed(os.path.join(HERE, f"coco_{i:02d}.npz"), **arrays)
        files.append(name)
        print(f"{name}: {len(data)} bytes")
    with open(os.path.join(HERE, "coco_scenes.json"), "w") as f:
        json.dump({"height": HW[0], "width": HW[1], "files": files,
                   "people": [people(i) for i in range(SCENES)]}, f)


if __name__ == "__main__":
    main()

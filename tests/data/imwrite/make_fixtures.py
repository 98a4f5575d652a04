"""cv2's bytes for the port's encoders (``core/imwrite.py``), stored as
SHA-256 digests for ``chip_smoke.py``'s ``encoders_phase``, which runs on a
machine without cv2:

    python tests/data/imwrite/make_fixtures.py    # needs cv2 and the JAX package

Writes beside itself:

- ``inputs.npz``: small synthetic images from a seed (``g_*`` gray, ``c_*``
  RGB, ``a_*`` RGBA), among them 1 x 1, odd widths, widths 7 and 8 (HDR's
  run-length threshold), a 300 x 400 gray ramp (15 TIFF strips) and a
  blocky 40 x 300 colour image (HDR runs);
- ``cv2_digests.json``:
  - ``encodes[input][ext]``: ``cv2.imencode(ext, image)`` of each input's
    BGR(A) counterpart, as ``{"sha256", "bytes", "cut"}`` (``cut`` 1: the
    digest leaves out the last byte, which cv2 reads from past the image
    for a Sun raster whose rows have an odd length; the port writes 0
    there), or ``{"refused": true, "left": ...}`` where cv2 refuses, with
    the hex of what ``cv2.imwrite`` leaves in the file (null: no file).
    The inputs are those of ``inputs.npz`` and ``coco_00`` ... ``coco_31``,
    the 480 x 640 scenes of ``tests/data/webp`` as the port decodes them
    (equal to cv2's decodes, ``tests/test_torch_port_webp.py``);
  - ``encoders480``: those 32 scenes as a COCO tree
    (``chip_smoke.py:scene_coco_tree``) named in turn by ``exts``, converted
    by the JAX package's ``transfer_coco``: ``files``, every file of the
    converted tree and its digest (``chip_smoke.py:tree_digests``: the
    records with their source directory as ``<images>``); the ``.pgm`` and
    ``.pbm`` mix previews are absent (cv2 refuses a colour image there and
    the converter goes on).

``tests/test_torch_port_imwrite.py`` holds the stored digests against live
cv2 and the port.
"""
import hashlib
import json
import os
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the tree the card converts)
from instancesegmentation_tpu_torch.core.imread import imread  # noqa: E402

SEED = 23
EXTS = (".jpe", ".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr",
        ".pic", ".gif", ".tif", ".tiff")
#: the encoders480 tree's names, two scenes each
TREE_EXTS = (".jpe", ".dib", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr", ".pic",
             ".gif", ".tif", ".tiff", ".pgm", ".pbm", ".JPE")
SCENES = os.path.join(ROOT, "tests", "data", "webp")
N_SCENES = 32


def synthetic_inputs() -> dict:
    rng = np.random.default_rng(SEED)
    out = {}
    for h, w in ((1, 1), (3, 7), (5, 8), (33, 46)):
        out[f"g_{h}x{w}"] = rng.integers(0, 256, (h, w), dtype=np.uint8)
        out[f"c_{h}x{w}"] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ramp = (np.add.outer(np.arange(300), np.arange(400)) // 3 % 256).astype(np.uint8)
    out["g_300x400"] = ramp ^ (rng.random((300, 400)) < 0.02).astype(np.uint8)
    out["c_40x300"] = np.repeat(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8), 10, axis=1)
    out["c_120x160"] = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    out["a_5x8"] = rng.integers(0, 256, (5, 8, 4), dtype=np.uint8)
    return out


def scene(i: int) -> np.ndarray:
    return imread(os.path.join(SCENES, f"coco_{i:02d}.webp"))


def bgr(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2:
        return image
    return np.ascontiguousarray(image[..., [2, 1, 0, 3][:image.shape[2]]])


def sunras_cut(ext: str, image: np.ndarray) -> int:
    channels = 1 if image.ndim == 2 else image.shape[2]
    return int(ext.lower() in (".sr", ".ras") and image.shape[1] * channels % 2 == 1)


def cv2_outcome(ext: str, image: np.ndarray, tmp: str) -> dict:
    ok, data = cv2.imencode(ext, bgr(image))
    if ok:
        data = data.tobytes()
        cut = sunras_cut(ext, image)
        return {"sha256": hashlib.sha256(data[:len(data) - cut]).hexdigest(),
                "bytes": len(data), "cut": cut}
    path = os.path.join(tmp, "refused" + ext)
    assert not cv2.imwrite(path, bgr(image))
    left = None
    if os.path.exists(path):
        with open(path, "rb") as f:
            left = f.read().hex()
        os.remove(path)
    return {"refused": True, "left": left}


def tree_digests(tmp: str) -> dict:
    from instancesegmentation_tpu.data.converters import transfer_coco

    with open(os.path.join(SCENES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    sources = [os.path.join(SCENES, f"coco_{i:02d}.webp") for i in range(N_SCENES)]
    img_dir, ann = chip_smoke.scene_coco_tree(os.path.join(tmp, "src"), sources, scenes,
                                              TREE_EXTS)
    out = os.path.join(tmp, "jax")
    assert transfer_coco(img_dir, ann, out, progress=False) == N_SCENES
    return chip_smoke.tree_digests(out, img_dir)


def main() -> None:
    inputs = synthetic_inputs()
    np.savez_compressed(os.path.join(HERE, "inputs.npz"), **inputs)
    encodes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, image in list(inputs.items()) + [(f"coco_{i:02d}", scene(i))
                                                   for i in range(N_SCENES)]:
            exts = EXTS if image.ndim == 2 or image.shape[2] == 3 else \
                (".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm", ".hdr", ".pic")
            encodes[name] = {ext: cv2_outcome(ext, image, tmp) for ext in exts}
        files = tree_digests(tmp)
    with open(os.path.join(HERE, "cv2_digests.json"), "w") as f:
        json.dump({"cv2": cv2.__version__, "encodes": encodes,
                   "encoders480": {"exts": TREE_EXTS, "files": files}}, f, indent=0)
        f.write("\n")
    print(f"{len(encodes)} inputs, {sum(map(len, encodes.values()))} encodes, "
          f"{len(files)} tree files")


if __name__ == "__main__":
    main()

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
    the converter goes on);
  - ``webp``: the port's WebP writer, whose bytes are not cv2's (libwebp's
    lossless encoder decides by heuristics) but decode to the same pixels:
    - ``encodes[input]``: ``port_sha256`` / ``port_bytes``, the port's
      ``imencode(".webp", image)``; ``decode_sha256``, cv2's
      ``IMREAD_UNCHANGED`` decode of those bytes as RGB(A), which this
      script asserts equal to the image as a reader gets it back
      (``chip_smoke.py:webp_read_back``); ``cv2_bytes``, the
      length of ``cv2.imencode(".webp")``'s own file;
    - ``webp_named480``: the 32 scenes as a COCO tree named ``exts`` in
      turn (``.webp``, two of them ``.WEBP``), converted by the JAX
      package's ``transfer_coco``: ``files``, the digest of every file but
      the mix previews (``tree_digests``); ``previews``, the SHA-256 of
      cv2's RGB decode of each ``.webp`` mix preview, and ``preview_cv2_bytes``
      its length;
- ``jp2``: cv2's ``.jp2`` files (OpenJPEG 2.5.3 at cv2's default rate 4),
  which the port writes byte for byte:
  - ``encodes[input]``: ``cv2.imencode(".jp2")`` of each input's BGR(A)
    counterpart as ``{"sha256", "bytes", "decode_sha256"}`` (the last:
    cv2's ``IMREAD_COLOR`` decode of the file, as RGB), or ``{"refused":
    true, "left": ...}`` (a side under 32);
  - ``jp2_named480``: the 32 JPEG 2000 scenes of ``tests/data/jpeg2000``
    as a COCO tree named ``.jp2`` (two of them ``.JP2``), converted by the
    JAX package's ``transfer_coco``: ``files``, the digest of every file,
    the ``.jp2`` mix previews included (``tree_digests``).

``tests/test_torch_port_imwrite.py`` and
``tests/test_torch_port_jpeg2000_enc.py`` hold the stored digests against
live cv2 and the port.
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
from instancesegmentation_tpu_torch.core.webp import encode_webp  # noqa: E402

SEED = 23
EXTS = (".jpe", ".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr",
        ".pic", ".gif", ".tif", ".tiff")
#: the encoders480 tree's names, two scenes each
TREE_EXTS = (".jpe", ".dib", ".ppm", ".pnm", ".pam", ".pfm", ".sr", ".ras", ".hdr", ".pic",
             ".gif", ".tif", ".tiff", ".pgm", ".pbm", ".JPE")
#: the webp_named480 tree's names: every scene ``.webp``, two of them ``.WEBP``
WEBP_TREE_EXTS = (".webp",) * 15 + (".WEBP",)
#: the jp2_named480 tree's names: every scene ``.jp2``, two of them ``.JP2``
JP2_TREE_EXTS = (".jp2",) * 15 + (".JP2",)
SCENES = os.path.join(ROOT, "tests", "data", "webp")
JP2_SCENES = os.path.join(ROOT, "tests", "data", "jpeg2000")
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


def sha256(data) -> str:
    return hashlib.sha256(np.ascontiguousarray(data) if isinstance(data, np.ndarray)
                          else data).hexdigest()


def jax_tree(tmp: str, exts: tuple, scenes_dir: str = SCENES,
             ext: str = ".webp") -> tuple[str, str]:
    """The 32 scenes ``coco_NN<ext>`` of ``scenes_dir`` as a COCO tree named
    ``exts`` in turn, converted by the JAX package: (the converted tree, the
    source image directory)."""
    from instancesegmentation_tpu.data.converters import transfer_coco

    with open(os.path.join(scenes_dir, "coco_scenes.json")) as f:
        scenes = json.load(f)
    sources = [os.path.join(scenes_dir, f"coco_{i:02d}{ext}") for i in range(N_SCENES)]
    tag = {WEBP_TREE_EXTS: "webp", JP2_TREE_EXTS: "jp2"}.get(exts, "enc")
    img_dir, ann = chip_smoke.scene_coco_tree(os.path.join(tmp, "src_" + tag), sources, scenes,
                                              exts)
    out = os.path.join(tmp, "jax_" + tag)
    assert transfer_coco(img_dir, ann, out, progress=False) == N_SCENES
    return out, img_dir


def tree_digests(tmp: str) -> dict:
    return chip_smoke.tree_digests(*jax_tree(tmp, TREE_EXTS))


def webp_outcome(image: np.ndarray) -> dict:
    data = encode_webp(image)
    ok, theirs = cv2.imencode(".webp", bgr(image))
    assert ok and data is not None
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    back = back[..., [2, 1, 0, 3][:back.shape[2]]]
    assert np.array_equal(back, chip_smoke.webp_read_back(image))
    return {"port_sha256": sha256(data), "port_bytes": len(data), "cv2_bytes": len(theirs),
            "decode_sha256": sha256(back)}


def webp_tree(tmp: str) -> dict:
    out, img_dir = jax_tree(tmp, WEBP_TREE_EXTS)
    files = chip_smoke.tree_digests(out, img_dir)
    previews, preview_bytes = {}, {}
    for rel in [r for r in files if r.startswith("mix/")]:
        with open(os.path.join(out, rel), "rb") as f:
            data = f.read()
        assert data[8:16] == b"WEBPVP8L"
        previews[rel] = sha256(cv2.imdecode(np.frombuffer(data, np.uint8),
                                            cv2.IMREAD_COLOR)[..., ::-1])
        preview_bytes[rel] = len(data)
        del files[rel]
    return {"exts": WEBP_TREE_EXTS, "files": files, "previews": previews,
            "preview_cv2_bytes": preview_bytes}


def jp2_outcome(image: np.ndarray, tmp: str) -> dict:
    out = cv2_outcome(".jp2", image, tmp)
    if not out.get("refused"):
        del out["cut"]
        ok, data = cv2.imencode(".jp2", bgr(image))
        out["decode_sha256"] = sha256(cv2.imdecode(data, cv2.IMREAD_COLOR)[..., ::-1])
    return out


def jp2_tree(tmp: str) -> dict:
    out, img_dir = jax_tree(tmp, JP2_TREE_EXTS, JP2_SCENES, ".jp2")
    return {"exts": JP2_TREE_EXTS, "files": chip_smoke.tree_digests(out, img_dir)}


def main() -> None:
    inputs = synthetic_inputs()
    np.savez_compressed(os.path.join(HERE, "inputs.npz"), **inputs)
    encodes, webp, jp2 = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, image in list(inputs.items()) + [(f"coco_{i:02d}", scene(i))
                                                   for i in range(N_SCENES)]:
            exts = EXTS if image.ndim == 2 or image.shape[2] == 3 else \
                (".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm", ".hdr", ".pic")
            encodes[name] = {ext: cv2_outcome(ext, image, tmp) for ext in exts}
            webp[name] = webp_outcome(image)
            jp2[name] = jp2_outcome(image, tmp)
        files = tree_digests(tmp)
        named = webp_tree(tmp)
        jp2_named = jp2_tree(tmp)
    with open(os.path.join(HERE, "cv2_digests.json"), "w") as f:
        json.dump({"cv2": cv2.__version__, "encodes": encodes,
                   "encoders480": {"exts": TREE_EXTS, "files": files},
                   "webp": {"encodes": webp, "webp_named480": named},
                   "jp2": {"encodes": jp2, "jp2_named480": jp2_named}}, f, indent=0)
        f.write("\n")
    print(f"{len(encodes)} inputs, {sum(map(len, encodes.values()))} encodes, "
          f"{len(files)} tree files; webp: the port's bytes "
          f"{sum(v['port_bytes'] for v in webp.values())} against cv2's "
          f"{sum(v['cv2_bytes'] for v in webp.values())}, {len(named['files'])} tree files and "
          f"{len(named['previews'])} previews; jp2: "
          f"{sum(not v.get('refused') for v in jp2.values())} files, "
          f"{len(jp2_named['files'])} tree files")


if __name__ == "__main__":
    main()

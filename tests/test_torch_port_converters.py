"""The port's dataset converters (``data/converters/``) against the JAX
package's (which write with cv2; CPU): the same source trees, made from a
seed, go through both, and the outputs must agree:

- the returned counts and the lists of files written;
- every ``data/*.json``, as text (so as parsed JSON and in key order);
- instance, segment and class masks, decoded;
- ``image/``: byte-equal copies for COCO and OCHuman, decoded-equal PNGs
  for Supervisely;
- ``mix/``: byte-equal for ``.jpg`` (the port's encoder is cv2's), decoded
  for ``.png``;
- ``draw_box`` / ``draw_keypoint`` bit-equal, with boxes and points partly
  or wholly outside the image;
- a Supervisely project with the 1-bit palette bitmaps its library writes;
- the three ``python -m`` entry points.

Mirrors ``tests/test_converters.py`` (COCO, OCHuman, Supervisely, the class
whitelist, the key migration) and ``tests/test_ingest_e2e.py`` (a converted
COCO tree read by the port's dataset as JAX's reads JAX's tree, then a few
port train steps on the CPU).
"""
import base64
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.core import visualize as jvis
from instancesegmentation_tpu.core.rasterize import rle_encode, rle_to_string
from instancesegmentation_tpu.data import converters as jconv
from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu_torch.core import visualize as tvis
from instancesegmentation_tpu_torch.core.keys import key_combine
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


# -- source trees ------------------------------------------------------------


def _person(rng, h, w, cx, cy, ax, ay, gray=False):
    """A textured image with a brighter ellipse (the person) and its mask."""
    img = rng.integers(20, 90, size=(h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
    img[inside] = np.clip(img[inside].astype(np.int32) + 130, 0, 255).astype(np.uint8)
    if gray:
        img = np.repeat(img[..., :1], 3, axis=2)
    return img, (inside * 255).astype(np.uint8)


def _keypoints(rng, cx, cy, ax, ay, n, visibilities):
    flat = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        flat += [int(cx + 0.6 * ax * np.cos(ang)), int(cy + 0.6 * ay * np.sin(ang)),
                 int(rng.choice(visibilities))]
    return flat


def _ellipse_polygon(cx, cy, ax, ay, n=12):
    ang = 2 * np.pi * np.arange(n) / n
    return np.stack([cx + ax * np.cos(ang), cy + ay * np.sin(ang)], 1).round(1).ravel().tolist()


def _coco_tree(root, seed=0, h=96, w=128, gray_jpeg=True):
    """COCO images (JPEG, one gray; one PNG; one listed but missing) with
    persons as polygons, compressed and uncompressed RLE, 17 keypoints of
    every visibility, boxes past the image's edges and a non-person."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    names = ["0000.jpg", "0001.jpg", "0002.png", "0003.jpg", "missing.jpg"]
    for i, name in enumerate(names):
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        img = np.zeros((h, w, 3), np.uint8)
        for j, kind in enumerate(("polygon", "rle", "counts")):
            cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
            ax, ay = rng.uniform(12, 40), rng.uniform(15, 45)
            person, mask = _person(rng, h, w, cx, cy, ax, ay)
            img = np.where(mask[..., None] > 0, person, np.maximum(img, person // 3))
            if kind == "polygon":
                segm = [_ellipse_polygon(cx, cy, ax, ay)]
            elif kind == "rle":
                segm = {"size": [h, w], "counts": rle_to_string(rle_encode(mask))}
            else:
                segm = rle_encode(mask)
            x0, y0 = cx - ax, cy - ay  # may lie outside: draw_box clips
            annotations.append({
                "id": 10 * i + j, "image_id": i, "category_id": 1,
                "bbox": [round(x0, 2), round(y0, 2), round(2 * ax, 2), round(2 * ay, 2)],
                "segmentation": segm,
                "keypoints": _keypoints(rng, cx, cy, ax, ay, 17, (0, 1, 2)),
            })
        annotations.append({"id": 10 * i + 9, "image_id": i, "category_id": 2,
                            "bbox": [0, 0, 10, 10], "segmentation": [[0, 0, 9, 0, 9, 9]],
                            "keypoints": None})
        if name == "missing.jpg":
            continue
        if gray_jpeg and i == 1:
            cv2.imwrite(os.path.join(img_dir, name), img[..., 0])
        else:
            cv2.imwrite(os.path.join(img_dir, name), img[..., ::-1])
    ann = {"categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "cat"}],
           "images": images, "annotations": annotations}
    ann_path = os.path.join(root, "instances.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return img_dir, ann_path


def _ochuman_tree(root, seed=1, h=90, w=120):
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images = []
    for i in range(3):
        img, _ = _person(rng, h, w, 60, 45, 30, 35)
        name = f"{i:06d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img[..., ::-1])
        anns = []
        for j in range(2):
            cx, cy = rng.uniform(20, w - 20), rng.uniform(20, h - 20)
            ann = {"bbox": [int(cx - 30), int(cy - 40), int(cx + 30), int(cy + 40)],
                   "keypoints": _keypoints(rng, cx, cy, 25, 30, 19, (0, 1, 2, 3)),
                   "segms": {"outer": [_ellipse_polygon(cx, cy, 28, 35)],
                             "inner": [_ellipse_polygon(cx, cy, 6, 8, n=6)]}}
            if j == 1 and i == 1:
                ann["segms"], ann["keypoints"] = None, None
            anns.append(ann)
        entry = {"file_name": name, "annotations": anns}
        if i != 2:  # the last one takes its size from the image
            entry.update(width=w, height=h)
        images.append(entry)
    images.append({"file_name": "gone.jpg", "width": w, "height": h, "annotations": []})
    ann_path = os.path.join(root, "ochuman.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images}, f)
    return img_dir, ann_path


def _palette_png(bits):
    """A Supervisely-library bitmap: 1-bit palette PNG, black transparent."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 1, 3, 0, 0, 0))
            + chunk(b"PLTE", bytes([0, 0, 0, 255, 255, 255])) + chunk(b"tRNS", b"\x00")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _bitmap(rng, ph, pw, palette):
    bits = rng.random((ph, pw)) > 0.3
    if palette:
        png = _palette_png(bits)
    else:
        ok, png = cv2.imencode(".png", bits.astype(np.uint8) * 255)
        png = png.tobytes()
    return base64.b64encode(zlib.compress(png)).decode()


def _supervisely_tree(root, seed=2, palette=True, h=80, w=100):
    """Two datasets of a project: PNG and JPEG images, bitmaps (palette or
    8-bit gray), polygons with holes, point keypoints, neutral objects."""
    rng = np.random.default_rng(seed)
    for ds, exts in (("ds0", (".png", ".jpg")), ("ds1", (".png",))):
        (os_ann, os_img) = (os.path.join(root, ds, "ann"), os.path.join(root, ds, "img"))
        os.makedirs(os_ann)
        os.makedirs(os_img)
        for k, ext in enumerate(exts):
            item = f"item{k}"
            img, _ = _person(rng, h, w, 50, 40, 25, 30)
            cv2.imwrite(os.path.join(os_img, item + ext), img[..., ::-1])
            ox, oy = int(rng.integers(0, 30)), int(rng.integers(0, 20))
            objects = [
                {"classTitle": "person_bmp", "geometryType": "bitmap", "instance": "A",
                 "bitmap": {"data": _bitmap(rng, 40, 30, palette), "origin": [ox, oy]}},
                {"classTitle": "nose", "geometryType": "point", "instance": "A",
                 "points": {"exterior": [[ox + 10, oy + 5]], "interior": []}},
                {"classTitle": "left_eye", "geometryType": "point", "instance": "A",
                 "points": {"exterior": [[w - 1, 0]], "interior": []}},
                {"classTitle": "person_poly", "geometryType": "polygon", "instance": "B",
                 "points": {"exterior": [[55, 30], [95, 25], [98, 78], [50, 70]],
                            "interior": [[[65, 40], [80, 40], [75, 55]]]}},
                {"classTitle": "persona", "geometryType": "polygon",
                 "points": {"exterior": [[-5, 60], [30, 50], [20, 90]], "interior": []}},
                {"classTitle": "neutral", "geometryType": "polygon", "instance": "C",
                 "points": {"exterior": [[0, 0], [5, 0], [5, 5]], "interior": []}},
            ]
            with open(os.path.join(os_ann, item + ".json"), "w") as f:
                json.dump({"size": {"height": h, "width": w}, "objects": objects}, f)
    return root


# -- comparison ----------------------------------------------------------------


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _same_tree(port, ref, image_bytes):
    """The two converted trees agree file by file (see the module's docstring)."""
    files = _files(ref)
    assert _files(port) == files
    for rel in files:
        a, b = os.path.join(port, rel), os.path.join(ref, rel)
        top = rel.split(os.sep)[0]
        if top == "data":
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), rel
        elif rel.endswith(".jpg") or (top == "image" and image_bytes):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
        else:
            want = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            got = cv2.imread(a, cv2.IMREAD_UNCHANGED)
            assert got.shape == want.shape, rel
            np.testing.assert_array_equal(got, want, err_msg=rel)
    return files


# -- the converters --------------------------------------------------------------


def test_transfer_coco_matches_jax(tmp_path, capsys):
    img_dir, ann_path = _coco_tree(str(tmp_path / "src"))
    n_port = tconv.transfer_coco(img_dir, ann_path, str(tmp_path / "port"), progress=False)
    n_jax = jconv.transfer_coco(img_dir, ann_path, str(tmp_path / "jax"), progress=False)
    assert n_port == n_jax == 4  # the missing file is skipped by both
    files = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), image_bytes=True)
    assert "mix/0002.png" in files and "mix/0000.jpg" in files
    assert len([f for f in files if f.startswith("instance_mask")]) == 12


def test_transfer_ochuman_matches_jax(tmp_path, capsys):
    img_dir, ann_path = _ochuman_tree(str(tmp_path / "src"))
    n_port = tconv.transfer_ochuman(ann_path, img_dir, str(tmp_path / "port"), progress=False)
    port_out = capsys.readouterr().out
    n_jax = jconv.transfer_ochuman(ann_path, img_dir, str(tmp_path / "jax"), progress=False)
    assert n_port == n_jax == 3
    assert port_out == capsys.readouterr().out == "Total images: 4\n"
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), image_bytes=True)


@pytest.mark.parametrize("palette", [False, True], ids=["gray_bitmaps", "palette_bitmaps"])
def test_transfer_supervisely_matches_jax(palette, tmp_path):
    """With cv2's 8-bit gray bitmaps (as ``tests/test_converters.py``
    writes them) and with the 1-bit palette bitmaps of real exports."""
    proj = _supervisely_tree(str(tmp_path / "proj"), palette=palette)
    n_port = tconv.transfer_supervisely_to_common(proj, str(tmp_path / "port"), progress=False)
    n_jax = jconv.transfer_supervisely_to_common(proj, str(tmp_path / "jax"), progress=False)
    assert n_port == n_jax == 3
    files = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), image_bytes=False)
    assert "image/00000.png" in files and "mix/00002.png" in files
    with open(tmp_path / "port" / "data" / "00000.json") as f:
        objs = json.load(f)[key_combine("object", "sub_list")]
    bitmap = objs[0]
    assert bitmap[key_combine("class", "class")] == "person"
    assert set(bitmap[key_combine("body_keypoint", "sub_dict")]) == {
        key_combine("nose", "sub_dict"), key_combine("left_eye", "sub_dict")}


def test_supervisely_class_whitelist(tmp_path):
    proj = tmp_path / "proj" / "ds0"
    (proj / "ann").mkdir(parents=True)
    (proj / "img").mkdir()
    cv2.imwrite(str(proj / "img" / "x.png"), np.zeros((8, 8, 3), np.uint8))
    sann = {"objects": [{"classTitle": "car", "geometryType": "polygon",
                         "points": {"exterior": [[0, 0], [1, 0], [1, 1]]}}]}
    (proj / "ann" / "x.json").write_text(json.dumps(sann))
    for convert in (tconv.transfer_supervisely_to_common, jconv.transfer_supervisely_to_common):
        with pytest.raises(AssertionError, match="not support"):
            convert(str(tmp_path / "proj"), str(tmp_path / "o"))


def test_unsupported_images_are_not_skipped(tmp_path):
    """cv2 reads a 10-bit AVIF that the port does not decode (ROADMAP A10
    part 3, step 6b; an RLE BMP, a TIFF, a WebP, a JPEG 2000, then an 8-bit
    AVIF, served here until their decoders landed): the port's converter
    stops with ``UnsupportedImage`` where a skip would drop an image that
    the JAX package converts.  The same tree with a WebP, a JPEG 2000 or an
    8-bit AVIF in that place converts as the JAX package converts it, file
    for file."""
    img_dir, ann_path = _coco_tree(str(tmp_path / "src"), gray_jpeg=False)
    pixels = np.random.default_rng(5).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    ok, webp = cv2.imencode(".webp", pixels)
    with open(os.path.join(img_dir, "0000.jpg"), "wb") as f:  # cv2 goes by content
        f.write(webp.tobytes())
    assert tconv.transfer_coco(img_dir, ann_path, str(tmp_path / "port_webp"), progress=False) == 4
    assert jconv.transfer_coco(img_dir, ann_path, str(tmp_path / "jax_webp"), progress=False) == 4
    _same_tree(str(tmp_path / "port_webp"), str(tmp_path / "jax_webp"), image_bytes=True)
    ok, jp2 = cv2.imencode(".jp2", pixels)
    with open(os.path.join(img_dir, "0000.jpg"), "wb") as f:
        f.write(jp2.tobytes())
    assert tconv.transfer_coco(img_dir, ann_path, str(tmp_path / "port_jp2"), progress=False) == 4
    assert jconv.transfer_coco(img_dir, ann_path, str(tmp_path / "jax_jp2"), progress=False) == 4
    _same_tree(str(tmp_path / "port_jp2"), str(tmp_path / "jax_jp2"), image_bytes=True)
    ok, avif = cv2.imencode(".avif", pixels)
    with open(os.path.join(img_dir, "0000.jpg"), "wb") as f:
        f.write(avif.tobytes())
    assert tconv.transfer_coco(img_dir, ann_path, str(tmp_path / "port_avif"), progress=False) == 4
    assert jconv.transfer_coco(img_dir, ann_path, str(tmp_path / "jax_avif"), progress=False) == 4
    _same_tree(str(tmp_path / "port_avif"), str(tmp_path / "jax_avif"), image_bytes=True)
    ok, avif = cv2.imencode(".avif", pixels.astype(np.uint16) * 257, [cv2.IMWRITE_AVIF_DEPTH, 10])
    with open(os.path.join(img_dir, "0000.jpg"), "wb") as f:
        f.write(avif.tobytes())
    assert cv2.imread(os.path.join(img_dir, "0000.jpg")) is not None
    assert jconv.transfer_coco(img_dir, ann_path, str(tmp_path / "jax"), progress=False) == 4
    with pytest.raises(ValueError, match="A10 part 3"):
        tconv.transfer_coco(img_dir, ann_path, str(tmp_path / "port"), progress=False)


def test_migrate_class_keys_matches_jax(tmp_path):
    old = {
        key_combine("class", "other"): "person",
        key_combine("object", "sub_list"): [{key_combine("class", "other"): "person"},
                                             {key_combine("class", "class"): "person"}],
        key_combine("class_mask", "sub_list"): [{key_combine("class", "other"): "person"}],
    }
    done = {key_combine("class", "class"): "person"}
    for side in ("port", "jax"):
        (tmp_path / side / "data").mkdir(parents=True)
        (tmp_path / side / "data" / "a.json").write_text(json.dumps(old))
        (tmp_path / side / "data" / "b.json").write_text(json.dumps(done))
    for _ in range(2):  # idempotent: 1 file, then none
        counts = (tconv.migrate_class_keys(str(tmp_path / "port")),
                  jconv.migrate_class_keys(str(tmp_path / "jax")))
        assert counts[0] == counts[1]
        assert _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), True)
    assert counts == (0, 0)


# -- drawing -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_draw_box_matches_jax(seed):
    """``cv2.rectangle`` (thickness 2, and 1, 3, 4) of boxes inside, across
    and wholly outside the image, integer, half-integer and fractional."""
    rng = np.random.default_rng(seed)
    for t in range(60):
        h, w = (int(v) for v in rng.integers(4, 48, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        box = rng.uniform(-20, 70, 4)
        if t % 3 == 0:
            box = np.round(box) + (0.5 if t % 2 else 0.0)
        thickness = 2 if t % 4 else int(rng.integers(1, 5))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = jvis.draw_box(img.copy(), list(box), color=color, thickness=thickness)
        got = tvis.draw_box(img.copy(), list(box), color=color, thickness=thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{box} {thickness}")


@pytest.mark.parametrize("seed", range(2))
def test_draw_keypoint_matches_jax(seed):
    rng = np.random.default_rng(seed)
    status_key, point_key = (key_combine("status", "keypoint_status"),
                             key_combine("point", "point_xy"))
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(4, 40, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        body = {key_combine(f"p{k}", "sub_dict"): {
            status_key: str(rng.choice(["vis", "not_vis", "missing"])),
            point_key: [int(v) for v in rng.integers(-6, 46, 2)]} for k in range(6)}
        body[key_combine("status", "other")] = "ignored"
        radius = int(rng.integers(0, 6))
        want = jvis.draw_keypoint(img.copy(), body, radius=radius)
        np.testing.assert_array_equal(tvis.draw_keypoint(img.copy(), body, radius=radius),
                                      want)
        want = jvis.draw_keypoint(img.copy(), body, labeled=True, radius=radius)
        np.testing.assert_array_equal(
            tvis.draw_keypoint(img.copy(), body, labeled=True, radius=radius), want)


# -- the entry points --------------------------------------------------------------


@pytest.mark.parametrize("source", ["coco", "ochuman", "supervisely"])
def test_python_m_entry_points(source, tmp_path):
    src = str(tmp_path / "src")
    if source == "coco":
        img_dir, ann_path = _coco_tree(src)
        args = [img_dir, ann_path]
        jconv.transfer_coco(img_dir, ann_path, str(tmp_path / "jax"), progress=False)
    elif source == "ochuman":
        img_dir, ann_path = _ochuman_tree(src)
        args = [ann_path, img_dir]
        jconv.transfer_ochuman(ann_path, img_dir, str(tmp_path / "jax"), progress=False)
    else:
        args = [_supervisely_tree(src)]
        jconv.transfer_supervisely_to_common(args[0], str(tmp_path / "jax"), progress=False)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", f"instancesegmentation_tpu_torch.data.converters.{source}",
         *args, str(tmp_path / "port")], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), image_bytes=source != "supervisely")


# -- ingestion: converted COCO tree -> dataset -> train steps ----------------------


def _ingest_tree(root):
    """A 4-image COCO tree at 240 x 320 as ``tests/test_ingest_e2e.py``
    builds it: one person per image, compressed-RLE masks."""
    rng = np.random.default_rng(11)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for i in range(4):
        h, w = 240, 320
        cx, cy, ax, ay = 150 + 8 * i, 120 + 5 * i, 60 + 4 * i, 80 + 3 * i
        img, mask = _person(rng, h, w, cx, cy, ax, ay)
        cv2.imwrite(os.path.join(img_dir, f"{i:04d}.jpg"), img[..., ::-1])
        ys, xs = np.nonzero(mask)
        x0, y0 = int(xs.min()), int(ys.min())
        images.append({"id": i, "file_name": f"{i:04d}.jpg", "height": h, "width": w})
        annotations.append({
            "id": 100 + i, "image_id": i, "category_id": 1,
            "bbox": [x0, y0, int(xs.max() - x0), int(ys.max() - y0)],
            "segmentation": {"size": [h, w], "counts": rle_to_string(rle_encode(mask))},
            "keypoints": _keypoints(rng, cx, cy, ax, ay, 17, (2,)),
        })
    ann_path = os.path.join(root, "instances.json")
    with open(ann_path, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "person"}], "images": images,
                   "annotations": annotations}, f)
    return img_dir, ann_path


def test_converted_coco_tree_trains(tmp_path):
    img_dir, ann_path = _ingest_tree(str(tmp_path / "src"))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann_path, port_dir, progress=False) == 4
    assert jconv.transfer_coco(img_dir, ann_path, jax_dir, progress=False) == 4
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
    for _ in range(6):
        state, metrics = train_step(state, batch, draws)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

"""The port's host data library against the JAX package and cv2 (CPU): the
PNG codec, ``fill_ellipse``, ``make_synthetic_dataset``, the record
operators, ``InstanceCommonDataset`` and ``batch_iterator`` /
``device_prefetch``.

The JAX package writes one synthetic directory per module; the port reads
it.  PNG files of every accepted colour type and filter come from a
test-side encoder (``_encode``), since cv2 writes only filter 1 (Sub).
"""
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.core import keys as JK
from instancesegmentation_tpu.core.records import common_ann_loader as jax_ann_loader
from instancesegmentation_tpu.data import dataset as jdataset
from instancesegmentation_tpu.data import pipeline as jpipe
from instancesegmentation_tpu.data.synthetic import make_synthetic_dataset as jax_make
from instancesegmentation_tpu.train.metrics import dump_image_grid as jax_dump_grid
from instancesegmentation_tpu_torch.core import keys as K
from instancesegmentation_tpu_torch.core.boxes import box_iou, mask2box
from instancesegmentation_tpu_torch.core.masks import mask_iou, union_masks
from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.png import (
    UnsupportedImage,
    decode_png,
    read_png,
    write_png,
)
from instancesegmentation_tpu_torch.core.rasterize import fill_ellipse
from instancesegmentation_tpu_torch.core.records import (
    ROOT_KEY,
    common_ann_loader,
    common_choice,
    common_filter,
    common_transfer,
    untyped_view,
)
from instancesegmentation_tpu_torch.data import pipeline as tpipe
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.synthetic import make_synthetic_dataset
from instancesegmentation_tpu_torch.train.metrics import dump_image_grid

torch.set_num_threads(1)

#: colour type -> channels (8-bit)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX-written synthetic directory: 6 images of 240x320, 2 objects each."""
    root = tmp_path_factory.mktemp("jax_synth")
    jax_make(str(root), num_images=6, objects_per_image=2, seed=1)
    return str(root)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(row, prev, f, bpp):
    """PNG filter ``f`` of one raw row (int arrays), the encoder's side."""
    a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    pred = {0: 0, 1: a, 2: prev, 3: (a + prev) // 2, 4: _paeth(a, prev, c)}[f]
    return ((row - pred) % 256).astype(np.uint8)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode(pixels, color, filters, depth=8, interlace=0, extra=()):
    """A PNG of ``pixels [H, W, C]`` with row ``y`` in ``filters[y]``."""
    h, w = pixels.shape[:2]
    bpp = pixels.shape[2] * depth // 8
    rows = pixels.reshape(h, -1).astype(np.int64)
    if depth == 16:
        rows = np.repeat(rows, 2, axis=1)
    raw = b""
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        raw += bytes([filters[y]]) + _filter_row(rows[y], prev, filters[y], bpp).tobytes()
        prev = rows[y]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(k, v) for k, v in extra)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _cv2_color(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_round_trips_with_cv2(tmp_path, channels):
    rng = np.random.default_rng(channels)
    pixels = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    pixels = pixels[..., 0] if channels == 1 else pixels
    bgr = [2, 1, 0, 3][:channels]
    for filter_type in (0, 1):
        # port -> cv2
        path = str(tmp_path / f"port{filter_type}.png")
        write_png(path, pixels, filter_type)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back if channels == 1 else back[..., bgr], pixels)
    # cv2 -> port, in both read modes of the file's kind
    path = str(tmp_path / "cv2.png")
    cv2.imwrite(path, pixels if channels == 1 else pixels[..., bgr])
    assert decode_png(open(path, "rb").read())[0, 0].size == channels
    np.testing.assert_array_equal(read_png(path, "color"), _cv2_color(path))
    if channels == 1:
        np.testing.assert_array_equal(read_png(path, "gray"), pixels)
        np.testing.assert_array_equal(read_png(path, "gray"),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    else:
        np.testing.assert_array_equal(read_png(path, "color"), pixels[..., :3])


@pytest.mark.parametrize("color", [0, 2, 4, 6], ids=["gray", "rgb", "gray_alpha", "rgba"])
@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
def test_png_filters_and_colour_types_match_cv2(tmp_path, color, filters):
    rng = np.random.default_rng(color * 10 + len(filters))
    h, w = 9, 13  # odd width
    pixels = rng.integers(0, 256, (h, w, CHANNELS[color]), dtype=np.uint8)
    rows = rng.integers(0, 5, h) if filters == "mixed" else [int(filters)] * h
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode(pixels, color, rows))
    np.testing.assert_array_equal(decode_png(open(path, "rb").read()), pixels)
    np.testing.assert_array_equal(read_png(path, "color"), _cv2_color(path))
    if color in (0, 4):
        np.testing.assert_array_equal(read_png(path, "gray"),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(read_png(path, "gray"), pixels[..., 0])


def test_png_raises(tmp_path):
    """What ``read_png`` refused before the remaining PNG forms were ported
    (16 bits, palettes, Adam7, a colour file read as gray) now reads as cv2
    reads it, and so do a WebP, a JPEG 2000 and an 8-bit AVIF since their
    decoders landed; corrupt files and a form the port does not decode (a
    10-bit AVIF, ROADMAP A10 part 3, step 6b) still raise."""
    px = np.random.default_rng(9).integers(0, 256, (4, 5, 3), dtype=np.uint8)

    def write(name, data):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        return path

    decoded = {
        "16.png": _encode(px, 2, [0] * 4, depth=16),
        "palette.png": _encode(px[..., :1] % 2, 3, [0] * 4, extra=[(b"PLTE", bytes(range(6)))]),
        # one pixel: Adam7's layout is the plain one (larger interlaced files
        # are in test_torch_port_png_forms.py)
        "adam7.png": _encode(px[:1, :1], 2, [0], interlace=1),
    }
    for name, data in decoded.items():
        path = write(name, data)
        np.testing.assert_array_equal(read_png(path, "color"), _cv2_color(path))
        np.testing.assert_array_equal(read_png(path, "gray"),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(write("text.png", b"not a png at all"))
    ok, webp = cv2.imencode(".webp", px)
    webp_path = write("image.webp", webp.tobytes())
    np.testing.assert_array_equal(imread(webp_path), _cv2_color(webp_path))
    ok, jp2 = cv2.imencode(".jp2", np.tile(px, (16, 16, 1)))  # OpenJPEG needs 33+ pixels a side
    jp2_path = write("image.jp2", jp2.tobytes())
    np.testing.assert_array_equal(imread(jp2_path), _cv2_color(jp2_path))
    ok, avif = cv2.imencode(".avif", np.tile(px, (16, 16, 1)))
    avif_path = write("image.avif", avif.tobytes())
    np.testing.assert_array_equal(imread(avif_path), _cv2_color(avif_path))
    ok, avif = cv2.imencode(".avif", np.tile(px, (16, 16, 1)).astype(np.uint16) * 257,
                            [cv2.IMWRITE_AVIF_DEPTH, 10])
    with pytest.raises(UnsupportedImage, match="A10 part 3, step 6b"):
        imread(write("image10.avif", avif.tobytes()))
    corrupt = bytearray(_encode(px, 2, [0] * 4))
    corrupt[40] ^= 0xFF  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        read_png(write("crc.png", bytes(corrupt)))
    rgb = write("rgb.png", _encode(px, 2, [1] * 4))
    np.testing.assert_array_equal(read_png(rgb, "gray"), cv2.imread(rgb, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(FileNotFoundError):
        read_png(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.float32))


# ---------------------------------------------------------------------------
# fill_ellipse
# ---------------------------------------------------------------------------

def _ellipse_cases():
    """The synthetic generator's ellipses: axis-aligned ones of
    ``make_synthetic_dataset`` (boxes 70-140 x 80-180 px) and the rotated
    crossed pairs (semi-axes 22-32 x 62-85, +-20-38 degrees), at 240x320
    and 480x640, plus small and partly outside ones."""
    rng = np.random.default_rng(11)
    cases = []
    for h, w in ((240, 320), (480, 640)):
        for _ in range(12):
            bw, bh = int(rng.uniform(70, min(140, w - 20))), int(rng.uniform(80, min(180, h - 20)))
            x0, y0 = int(rng.uniform(0, w - bw)), int(rng.uniform(0, h - bh))
            cases.append(((h, w), (x0 + bw // 2, y0 + bh // 2), (bw // 2 - 2, bh // 2 - 2), 0.0))
        for _ in range(12):
            a_min, a_maj = rng.uniform(22, 32), rng.uniform(62, 85)
            cx, cy = rng.uniform(90, w - 90), rng.uniform(90, h - 90)
            ang = rng.choice([-1, 1]) * rng.uniform(20.0, 38.0)
            cases.append(((h, w), (int(cx), int(cy)), (int(a_min), int(a_maj)), float(ang)))
    for _ in range(16):  # small axes (other angular steps) and image borders
        cases.append(((60, 80), (int(rng.uniform(-10, 90)), int(rng.uniform(-10, 70))),
                      (int(rng.uniform(0, 40)), int(rng.uniform(0, 40))),
                      float(rng.uniform(-180, 180))))
    return cases


def test_fill_ellipse_matches_cv2():
    for hw, center, axes, angle in _ellipse_cases():
        want = np.zeros(hw, np.uint8)
        cv2.ellipse(want, center, axes, angle, 0, 360, 255, -1)
        got = fill_ellipse(np.zeros(hw, np.uint8), center, axes, angle)
        np.testing.assert_array_equal(got, want, err_msg=str((hw, center, axes, angle)))


# ---------------------------------------------------------------------------
# synthetic datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(num_images=4, objects_per_image=2, seed=1),
                                dict(num_images=3, crossed_pairs=True, seed=3),
                                dict(num_images=2, image_hw=(480, 640), seed=5)],
                         ids=["plain", "crossed_pairs", "480x640"])
def test_make_synthetic_dataset_matches_jax(tmp_path, kw):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_make(a, **kw)
    make_synthetic_dataset(b, **kw)
    files = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    assert len(files) == kw["num_images"] * (4 + (2 if kw.get("crossed_pairs")
                                                  else kw.get("objects_per_image", 1)))
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".json"):
            assert json.load(open(pa)) == json.load(open(pb)), rel
        else:
            np.testing.assert_array_equal(cv2.imread(pb, cv2.IMREAD_UNCHANGED),
                                          cv2.imread(pa, cv2.IMREAD_UNCHANGED), err_msg=rel)


# ---------------------------------------------------------------------------
# the reader on the JAX-written directory
# ---------------------------------------------------------------------------

def test_records_match_jax(jax_dir):
    assert list(common_ann_loader(jax_dir)) == list(jax_ann_loader(jax_dir))
    port = InstanceCommonDataset(jax_dir, canvas=192)
    ref = jdataset.InstanceCommonDataset(jax_dir, canvas=192)
    assert len(port) == len(ref) == 12
    assert port.records == ref.records


@pytest.mark.parametrize("canvas", [192, 320], ids=["prescaled", "not_prescaled"])
def test_fetch_matches_jax(jax_dir, canvas):
    port = InstanceCommonDataset(jax_dir, canvas=canvas)
    ref = jdataset.InstanceCommonDataset(jax_dir, canvas=canvas)
    for i in range(len(ref)):
        got, want = port.fetch(i), ref.fetch(i)
        for field in ("image", "mask", "image_hw", "obj_box", "mask_box", "keypoints"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=f"sample {i} {field}")
        assert got.mask_valid == want.mask_valid and got.index == want.index
    if canvas == 192:  # 320 px wide images were prescaled to 192 x 144
        assert tuple(port.fetch(0).image_hw) == (144.0, 192.0)


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_matches_jax(jax_dir, drop_last):
    port = InstanceCommonDataset(jax_dir, canvas=192)
    ref = jdataset.InstanceCommonDataset(jax_dir, canvas=192)
    kw = dict(batch_size=5, shuffle=True, seed=4, epochs=2, drop_last=drop_last, num_threads=3)
    got = list(tpipe.batch_iterator(port, **kw))
    want = list(jpipe.batch_iterator(ref, **kw))
    assert len(got) == len(want) == (4 if drop_last else 6)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_batch_iterator_stops_and_raises(jax_dir):
    ds = InstanceCommonDataset(jax_dir, canvas=192)
    # abandoning a stream that runs forever releases its producer
    it = tpipe.batch_iterator(ds, batch_size=2, epochs=None, num_threads=2, prefetch=1)
    next(it)
    it.close()
    # a failing decode reaches the consumer
    broken = InstanceCommonDataset(jax_dir, canvas=192)
    broken.records[3] = dict(broken.records[3])
    broken.records[3][K.key_combine("image", "image_path")] = "image/missing.png"
    with pytest.raises(FileNotFoundError):
        list(tpipe.batch_iterator(broken, batch_size=4, shuffle=False, num_threads=2))
    # a local slice (ported: data parallelism) yields only its rows
    it = tpipe.batch_iterator(ds, batch_size=2, num_threads=2, local_slice=slice(0, 1))
    assert next(it)["image"].shape[0] == 1
    it.close()


def test_device_prefetch_keeps_batches(jax_dir):
    ds = InstanceCommonDataset(jax_dir, canvas=192)
    host = list(tpipe.batch_iterator(ds, batch_size=4, shuffle=False, num_threads=2))
    got = list(tpipe.device_prefetch(iter(host), "cpu", depth=2))
    assert len(got) == len(host) == 3
    for g, h in zip(got, host):
        for k, v in h.items():
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), v)


def test_image_grid_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (3, 16, 20, 3)).astype(np.float32)
    targets = rng.random((3, 16, 20, 1)).astype(np.float32)
    probs = rng.random((3, 16, 20, 1)).astype(np.float32)
    a = jax_dump_grid(str(tmp_path / "jax"), "g", images, targets, probs)
    b = dump_image_grid(str(tmp_path / "port"), "g", images, targets, probs)
    np.testing.assert_array_equal(read_png(b), _cv2_color(a))
    assert read_png(b).shape == (48, 80, 3)


# ---------------------------------------------------------------------------
# mirrored from tests/test_core.py and tests/test_data_pipeline.py
# ---------------------------------------------------------------------------

def test_keys_match_jax():
    for name in ("KEY_SEP", "KEY_TYPES", "ORDER_PART_NAMES", "COCO_PART_NAMES",
                 "OCHUMAN_PART_NAMES", "COCO_VISIBILITY_MAP", "OCHUMAN_VISIBILITY_MAP",
                 "BODY_PART_CHOICES", "CLASS_CHOICES", "COCO_SKELETON"):
        assert getattr(K, name) == getattr(JK, name), name
    key = K.key_combine("box", "box_xyxy")
    assert key == "box##box_xyxy" and K.key_decompose(key) == ("box", "box_xyxy")
    with pytest.raises(ValueError):
        K.key_combine("box", "nonsense")
    assert tpipe.ORDER_PART_NAMES is K.ORDER_PART_NAMES


def _toy_record():
    return {
        K.key_combine("image", "image_path"): "image/a.png",
        K.key_combine("object", "sub_list"): [
            {
                K.key_combine("class", "class"): "person",
                K.key_combine("box", "box_xyxy"): [10, 20, 110, 220],
                K.key_combine("body_keypoint", "sub_dict"): {
                    K.key_combine("nose", "sub_dict"): {
                        K.key_combine("status", "keypoint_status"): "vis",
                        K.key_combine("point", "point_xy"): [50, 60],
                    }
                },
            }
        ],
        K.key_combine("meta", "other"): {"width": 320, "height": 240},
    }


def test_record_operators():
    rec = _toy_record()
    common_choice(rec, {"image", "object"})
    assert set(rec) == {K.key_combine("image", "image_path"),
                        K.key_combine("object", "sub_list")}
    view = untyped_view(_toy_record())
    assert view["object"][0]["class"] == "person"
    assert view["object"][0]["body_keypoint"]["nose"]["status"] == "vis"

    def good(result):
        yield "box" in result
        x0, y0, x1, y1 = result["box"]
        yield (x1 - x0) > 50 and (y1 - y0) > 50

    def bad(result):
        yield "instance_mask" in result
        raise AssertionError("not short-circuited")

    obj = _toy_record()[K.key_combine("object", "sub_list")][0]
    assert common_filter(obj, good)
    assert not common_filter(obj, bad)


def test_loader_and_transfer_roundtrip(tmp_path):
    """cv2-written files through the port's loader (BGR file content comes
    back as RGB)."""
    root = tmp_path / "ds"
    (root / "data").mkdir(parents=True)
    (root / "image").mkdir()
    (root / "instance_mask" / "a").mkdir(parents=True)
    img = np.zeros((8, 12, 3), dtype=np.uint8)
    img[:, :, 2] = 200  # red in RGB
    cv2.imwrite(str(root / "image" / "a.png"), img)
    mask = np.zeros((8, 12), dtype=np.uint8)
    mask[2:5, 3:7] = 255
    cv2.imwrite(str(root / "instance_mask" / "a" / "0.png"), mask)
    ann = {
        K.key_combine("image", "image_path"): "image/a.png",
        K.key_combine("object", "sub_list"): [
            {K.key_combine("instance_mask", "mask_path"): "instance_mask/a/0.png"}
        ],
    }
    (root / "data" / "a.json").write_text(json.dumps(ann))
    anns = list(common_ann_loader(str(root)))
    assert len(anns) == 1 and anns[0][ROOT_KEY] == str(root)
    rec = anns[0]
    common_transfer(rec)
    loaded = rec[K.key_combine("image", "image")]
    assert loaded.shape == (8, 12, 3) and loaded[0, 0, 0] == 200 and loaded[0, 0, 2] == 0
    m = rec[K.key_combine("object", "sub_list")][0][K.key_combine("instance_mask", "mask")]
    assert m.shape == (8, 12) and mask2box(m) == [3, 2, 7, 5]


def test_boxes_and_masks():
    assert mask2box(np.full((4, 6), 255, np.uint8)) == [0, 0, 6, 4]
    assert mask2box(np.zeros((4, 6), np.uint8)) is None
    iou = box_iou(np.array([[0, 0, 10, 10]]),
                  np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]]))[0]
    np.testing.assert_allclose(iou, [1.0, 25 / 175, 0.0])
    a = np.zeros((10, 10), np.uint8)
    b = np.zeros((10, 10), np.uint8)
    a[:5] = b[5:] = 255
    assert mask_iou(a, b) == 0.0 and mask_iou(a, a) == 1.0
    assert mask_iou(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0
    u = union_masks([a, b])
    assert (u == 255).all()


def test_index_filter_and_fetch_shapes(jax_dir):
    ds = InstanceCommonDataset(jax_dir, canvas=384)
    assert len(ds) == 12  # 6 images x 2 objects, all eligible by construction
    s = ds.fetch(0)
    assert s.image.shape == (384, 384, 3) and s.mask.shape == (384, 384)
    assert s.keypoints.shape == (17, 3) and s.mask_valid
    assert (s.keypoints[:, 2] == 1.0).all()
    h, w = s.image_hw.astype(int)
    assert s.mask[h:, :].sum() == 0 and s.mask[:, w:].sum() == 0


def test_batch_iterator_epochs_shapes_and_padding(jax_dir):
    ds = InstanceCommonDataset(jax_dir, canvas=384)
    n = 0
    for batch in tpipe.batch_iterator(ds, batch_size=4, shuffle=True, epochs=2, seed=3):
        assert batch["image"].shape == (4, 384, 384, 3)
        n += 1
    assert n == 2 * (len(ds) // 4)
    batches = list(tpipe.batch_iterator(ds, batch_size=5, shuffle=False, epochs=1,
                                        drop_last=False))
    assert len(batches) == 3  # 12 samples -> 5, 5, 2 padded to 5
    assert batches[-1]["image"].shape[0] == 5
    np.testing.assert_array_equal(batches[-1]["image"][2:],
                                  np.repeat(batches[-1]["image"][:1], 3, axis=0))
